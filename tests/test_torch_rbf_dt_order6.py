"""PyTorch port vs the JAX package: the dt engine on RBF's spectral family at
order 6, the order of chip_smoke.py's RBF model — the four plain passes and ``pkfs_dt`` against the
JAX time-last engine, ``lml_dt`` and its gradients against JAX autodiff; f64
on the CPU, same numpy inputs (_torch_rbf_dt.py)."""
import torch

from _torch_rbf_dt import check_four_passes_and_pkfs_dt, check_lml_dt_value_and_grads

torch.set_num_threads(1)


def test_four_passes_and_pkfs_dt_match_jax():
    check_four_passes_and_pkfs_dt(6)


def test_lml_dt_value_and_grads_match_jax():
    check_lml_dt_value_and_grads(6)
