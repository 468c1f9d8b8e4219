"""PyTorch port vs the JAX package: Matérn SDEs, transition coefficients,
balancing, the Lyapunov solve and the softplus hyperparameters
(parallel_gps_torch.kernels / ops vs parallel_gps_tpu), f64 on the CPU, same
numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.models.params import inv_softplus, softplus
from parallel_gps_torch.ops.balance import balance_scale
from parallel_gps_torch.ops.lyapunov import solve_lyap_vec
from parallel_gps_tpu.ops.balance import balance_scale as j_balance_scale
from parallel_gps_tpu.ops.lyapunov import solve_lyap_vec as j_solve_lyap_vec
from _torch_common import _np
from _torch_sde import IDS, KERNELS, _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("name,v,ell", KERNELS, ids=IDS)
def test_get_sde_matches_jax(name, v, ell):
    jkern, tkern = _pair(name, v, ell)
    assert tkern.state_dim == jkern.state_dim
    for field, a, b in zip("P0 F L H Q".split(), jkern.get_sde(), tkern.get_sde()):
        npt.assert_allclose(_np(b), _np(a), rtol=1e-12, atol=1e-14, err_msg=f"{name}.{field}")


@pytest.mark.parametrize("name,v,ell", KERNELS, ids=IDS)
def test_transition_coeffs_and_build_match_jax(name, v, ell):
    jkern, tkern = _pair(name, v, ell)
    j_coeffs, j_build = jkern.transition_coeffs()
    family, t_coeffs = tkern.transition_coeffs()
    assert family == "exppoly"
    npt.assert_allclose(_np(t_coeffs), _np(j_coeffs), rtol=1e-12, atol=1e-14)
    dts = np.random.RandomState(0).rand(37) * 0.1
    rows = j_build(list(j_coeffs), jnp.asarray(dts))
    Am1 = tkern.transitions_m1_tl(torch.tensor(dts))
    d = tkern.state_dim
    for i in range(d):
        for j in range(d):
            npt.assert_allclose(_np(Am1[i, j]), _np(rows[i][j]), rtol=1e-12, atol=1e-14)


def test_balance_and_lyapunov_match_jax():
    rng = np.random.RandomState(3)
    F = rng.randn(4, 4) * np.array([1.0, 10.0, 100.0, 0.1])
    F[2, 0] = 0.0
    jd = j_balance_scale(jnp.asarray(F), 10)
    td = balance_scale(torch.tensor(F), 10)
    npt.assert_allclose(_np(td), _np(jd), rtol=1e-12)
    Fs = -np.eye(3) + 0.3 * rng.randn(3, 3)
    L = rng.randn(3, 1)
    Q = np.array([[0.7]])
    jP = j_solve_lyap_vec(jnp.asarray(Fs), jnp.asarray(L), jnp.asarray(Q))
    tP = solve_lyap_vec(torch.tensor(Fs), torch.tensor(L), torch.tensor(Q))
    npt.assert_allclose(_np(tP), _np(jP), rtol=1e-11, atol=1e-13)


def test_positive_hyperparameters_round_trip_through_softplus():
    y = torch.tensor([1e-6, 0.3, 1.0, 25.0, 300.0], dtype=torch.float64)
    npt.assert_allclose(_np(softplus(inv_softplus(y))), _np(y), rtol=1e-12)
    x = np.linspace(-30.0, 40.0, 11)
    npt.assert_allclose(_np(softplus(torch.tensor(x))), np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-14)
    k = tk.Matern52(0.8, 0.4, dtype=torch.float64, device="cpu")
    assert {n for n, _ in k.named_parameters()} == {"raw_variance", "raw_lengthscales"}
    npt.assert_allclose(k.variance.item(), 0.8, rtol=1e-14)
    npt.assert_allclose(k.lengthscales.item(), 0.4, rtol=1e-14)
