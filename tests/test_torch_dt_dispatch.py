"""PyTorch port: the CPU dispatch contract of the dt-engine's kernel wrappers,
the port running with no JAX loaded, and ``lml_dt``'s backward against
autograd through the plain filter's scan; f64 on the CPU."""
import json
import subprocess
import sys
import textwrap

import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import timelast as ttl
from _torch_dt import _data, _torch_inputs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fresh_process_facts():
    """Import the port and each of its modules (the probe programs too) in a
    fresh interpreter, run the model once on the CPU at T = 70 (LML, a
    gradient, predict_f, a step of each optimiser and a batched LML with its
    gradient), and report which modules were loaded and which kernels
    launched."""
    code = textwrap.dedent(
        """
        import json, sys
        import parallel_gps_torch as pgt
        import parallel_gps_torch.inference.optim, parallel_gps_torch.models.params
        import parallel_gps_torch.kalman.dt, parallel_gps_torch.kalman.timelast
        import parallel_gps_torch.kalman.batched, parallel_gps_torch.inference.mcmc
        import parallel_gps_torch.experiments.common
        import parallel_gps_torch.probes.dma, parallel_gps_torch.probes.attrib, parallel_gps_torch.probes.grid
        import numpy as np
        import torch
        from parallel_gps_torch.kalman import batched, dt
        rng = np.random.RandomState(0)
        t = np.sort(rng.rand(70)); y = np.sin(t); y[::7] = np.nan
        m = pgt.StateSpaceGP.from_numpy(t, y, "Matern52", 0.8, 0.4, 0.1, dtype=torch.float64, device="cpu")
        m.log_marginal_likelihood().backward(); m.predict_f(rng.rand(5))
        pgt.inference.fit_adam(m, n_iters=1); pgt.inference.fit_lbfgs(m, n_iters=1)
        chains = pgt.StateSpaceGP.from_numpy(t, y, "Matern52", np.full(3, 0.8), np.full(3, 0.4), np.full(3, 0.1),
                                             dtype=torch.float64, device="cpu")
        chains.log_marginal_likelihood().sum().backward()
        foreign = ("jax", "jaxlib", "flax", "optax", "parallel_gps_tpu")
        print(json.dumps({
            "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in foreign),
            "launches": {**dt.LAUNCHES, **batched.LAUNCHES},
            "cuda_loader_imported": "parallel_gps_torch.kalman._cuda" in sys.modules,
        }))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax(fresh_process_facts):
    """Importing and running the port (serving and training) leaves jax,
    flax, optax and the JAX package unloaded."""
    assert fresh_process_facts["jax_modules"] == []


def test_cpu_dispatch_launches_no_kernel_and_loads_no_build_step(fresh_process_facts):
    """On the CPU every wrapper takes its plain version: no launch counter
    moves and the CUDA loader (kalman/_cuda.py) is never imported."""
    assert set(fresh_process_facts["launches"].values()) == {0}
    assert not fresh_process_facts["cuda_loader_imported"]


def test_non_cpu_tensors_never_fall_back_to_the_plain_version():
    """A tensor on a device other than the CPU goes to the kernel wrapper,
    which refuses what it cannot launch instead of falling back."""
    fam, co, P0, H, R, dts, ty = _torch_inputs(tk.Matern32(1.0, 0.5, dtype=torch.float64, device="cpu"), *_data(50, 1))
    meta = [x.to("meta") for x in (co, P0, H, R, dts, ty)]
    with pytest.raises(ValueError, match="CUDA device"):
        tdt.strip_filter_dt(fam, *meta)
    b, C = torch.zeros(2, 50, device="meta"), torch.zeros(2, 2, 50, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tdt.dt_smoother_scan(fam, meta[0], meta[1], meta[4], b, C)
    with pytest.raises(ValueError, match="CUDA device"):
        tdt.dt_fisher(fam, *meta, b, C, b, C)
    # The spectral family (RBF) and the composite family (a Periodic × Matérn)
    # are refused the same way.
    for kern in (
        tk.RBF(1.0, 0.5, order=4, dtype=torch.float64, device="cpu"),
        tk.Periodic(1.0, 1.0, 1.0, order=1, dtype=torch.float64, device="cpu") * tk.Matern32(1.0, 0.5, dtype=torch.float64, device="cpu"),
    ):
        fam, co, P0, H, R, dts, ty = _torch_inputs(kern, *_data(50, 1))
        with pytest.raises(ValueError, match="CUDA device"):
            tdt.strip_filter_dt(fam, *(x.to("meta") for x in (co, P0, H, R, dts, ty)))
    kernels = {"dt_filter_scan", "dt_filter_apply", "dt_smoother_scan", "dt_smoother_apply", "dt_fisher"}
    assert set(tdt.LAUNCHES) == kernels | {f"{k}_{f}" for k in kernels for f in ("spectral", "composite")}
    assert set(tdt.LAUNCHES.values()) == {0}


def test_lml_dt_gradient_is_the_fisher_backward():
    """``lml_dt`` is differentiable: its backward (smoother + Fisher tail)
    gives the gradient that autograd through the plain filter's scan gives,
    rtol 1e-7 / atol 1e-10 (tests/test_torch_fisher_lml_dt.py holds it
    against the JAX package)."""
    t, y = _data(40, 2)
    R = torch.tensor([[0.1]], dtype=torch.float64)
    grads = []
    for through_scan in (False, True):
        k = tk.Matern32(1.0, 0.5, dtype=torch.float64, device="cpu")
        if through_scan:
            ell = ttl.pkf_from_tl(k.get_ssm_tl(torch.tensor(t), R), torch.tensor(y), True)[2]
        else:
            ell = tdt.lml_dt(k, torch.tensor(t), R, torch.tensor(y))
        assert ell.requires_grad
        ell.backward()
        grads.append([k.raw_variance.grad.item(), k.raw_lengthscales.grad.item()])
    npt.assert_allclose(grads[0], grads[1], rtol=1e-7, atol=1e-10)
