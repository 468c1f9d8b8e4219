"""PyTorch port: the dense GP oracle (models/gpr.py) against the state-space
models, sequential and parallel; f64 on the CPU."""
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.models import GPR

torch.set_num_threads(1)


GPR_COVS = [
    # (kernel, options, value tolerance, gradient tolerance): tests/test_gp_vs_kfs.py:37-40.
    # RBF at the port's highest order: its order-8 SDE approximates the SE
    # kernel far less closely than that file's order 15 (the LML is 4% from
    # the dense one), so only the value and the posterior are held, loosely;
    # the port's RBF model is held against the JAX one at rtol 1e-7 in
    # test_torch_model_rbf.py.
    ("Matern12", {}, 1e-6, 1e-2),
    ("Matern32", {}, 1e-6, 1e-2),
    ("Matern52", {}, 1e-6, 1e-2),
    ("RBF", {"order": 8, "balancing_iter": 10}, 5e-2, None),
]


@pytest.mark.parametrize("name,options,val_tol,grad_tol", GPR_COVS, ids=[c[0] for c in GPR_COVS])
def test_dense_gpr_oracle_against_kfs(name, options, val_tol, grad_tol):
    """The dense GP (models/gpr.py) against the state-space model, sequential
    and parallel, on the data protocol of tests/test_gp_vs_kfs.py (T = 200
    sorted uniform times, noisy sinusoid, K = 50 queries): LML, its gradients
    w.r.t. the unconstrained hyperparameters, and the posterior."""
    from parallel_gps_torch.toymodels import obs_noise, sinu

    rng = np.random.RandomState(31415926)
    t = np.sort(rng.rand(200))
    y = obs_noise(sinu(t), 0.1, 42)
    query = np.sort(rng.rand(50))
    models = [
        StateSpaceGP.from_numpy(t, y, name, 1.0, 0.5, 0.1, dtype=torch.float64, device="cpu", parallel=p, **options)
        for p in (True, False)
    ]
    ref = models[0]
    ref.zero_grad(set_to_none=True)
    gp = GPR(ref.ts, ref.ys, ref.kernel, ref.noise_variance)
    gp_val = gp.log_marginal_likelihood()
    gp_val.backward()
    gp_grads = [float(p.grad) for p in ref.parameters()]
    with torch.no_grad():
        mean_gp, var_gp = GPR(ref.ts, ref.ys, ref.kernel, ref.noise_variance).predict_f(torch.tensor(query))
    for tm in models:
        tm.zero_grad(set_to_none=True)
        val = tm.log_marginal_likelihood()
        val.backward()
        npt.assert_allclose(float(val.detach()), float(gp_val.detach()), atol=val_tol, rtol=val_tol)
        if grad_tol is not None:
            npt.assert_allclose([float(p.grad) for p in tm.parameters()], gp_grads, atol=grad_tol, rtol=grad_tol)
        mean, var = tm.predict_f(query)
        npt.assert_allclose(mean.numpy(), mean_gp.numpy(), atol=val_tol, rtol=val_tol)
        npt.assert_allclose(var.numpy(), var_gp.numpy(), atol=val_tol, rtol=val_tol)
