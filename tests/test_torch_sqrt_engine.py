"""PyTorch port vs the JAX package: the square-root engine
(kalman/sqrt.py) — ``tria`` and ``psd_sqrt``, the quadrature noise
factors, both combines, the filter, smoother and LML on Matern52 and on
RBF(order=12), the all-NaN series, chains and the precision guard; f64 on
the CPU.  Factors are compared through their products (QR's sign
convention is the library's)."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch.kalman import sqrt as S
from parallel_gps_torch.kernels import RBF, Matern32, Matern52
from parallel_gps_tpu.kalman import sqrt as J
from parallel_gps_tpu.types import LGSSM as JLGSSM
from _torch_common import jit_o0

torch.set_num_threads(1)
F64 = dict(dtype=torch.float64, device="cpu")
NOISE = 0.1


def _close(a, ref, rtol):
    ref = np.asarray(ref)
    npt.assert_allclose(np.asarray(a), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _gram(N):
    return N @ (N.transpose(-1, -2) if isinstance(N, torch.Tensor) else jnp.swapaxes(N, -1, -2))


def _data(T, seed):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.rand(T) < 0.1] = np.nan
    return t, y


KERNELS = {
    "m32": (lambda: jk.Matern32(0.9, 0.4), lambda: Matern32(0.9, 0.4, **F64)),
    "m52": (lambda: jk.Matern52(0.9, 0.4), lambda: Matern52(0.9, 0.4, **F64)),
    "rbf12": (lambda: jk.RBF(1.0, 0.25, order=12, balancing_iter=5), lambda: RBF(1.0, 0.25, order=12, balancing_iter=5, **F64)),
}


class _JaxKernel:
    """A JAX kernel whose ``get_sde`` returns the port's SDE as JAX arrays
    (the two are held equal in test_torch_sde*.py): the JAX quadrature
    then compiles without the SDE build's balancing and Lyapunov solve."""

    def __init__(self, jkern, tkern):
        from parallel_gps_tpu.types import ContinuousDiscreteModel

        self.kernel = jkern
        with torch.no_grad():
            self.sde = ContinuousDiscreteModel(*(jnp.asarray(x.numpy()) for x in tkern.get_sde()))

    def get_sde(self):
        return self.sde

    def transitions_m1(self, dts):
        return self.kernel.transitions_m1(dts)


def _port_inputs(tkern, t):
    """The port's time-first model and quadrature factors of the times
    ``t``, no autograd."""
    with torch.no_grad():
        lgssm, ts = S._kernel_model(tkern, torch.tensor(t), torch.tensor([[NOISE]], dtype=torch.float64), 0.0)
        sqQ, sqP0 = S.kernel_sq_factors(tkern, ts, lgssm, None, 0.0)
    return lgssm, sqQ, sqP0


def test_tria_and_psd_sqrt_through_products():
    rng = np.random.RandomState(0)
    M = rng.randn(5, 4, 7)
    L = S.tria(torch.tensor(M))
    assert torch.equal(L, torch.tril(L))
    _close(_gram(L).numpy(), M @ np.swapaxes(M, -1, -2), 1e-13)
    _close(_gram(L).numpy(), _gram(jit_o0(J.tria)(jnp.asarray(M))), 1e-13)
    A = rng.randn(4, 3)
    P = A @ A.T  # PSD and singular: eigh's clamped root, no NaN
    R = S.psd_sqrt(torch.tensor(P))
    assert bool(torch.isfinite(R).all())
    _close((R @ R).numpy(), P, 1e-12)
    _close(R.numpy(), jit_o0(J.psd_sqrt)(jnp.asarray(P)), 1e-10)


@pytest.mark.parametrize("name", ["m32", "rbf12"])
def test_gramian_disc_factors(name):
    """The quadrature factors equal the JAX ones (a fixed computation, no
    sign choice) and factor the discretised Q planes."""
    make_j, make_t = KERNELS[name]
    tkern = make_t()
    t, _ = _data(60, 1)
    dts = np.diff(t, prepend=0.0)
    d = tkern.state_dim
    with torch.no_grad():
        G = S.gramian_disc_factors(tkern, torch.tensor(dts), max(8, d + 2))
        Qs = tkern.get_ssm(torch.tensor(t), torch.tensor([[NOISE]], dtype=torch.float64)).Qs
    want = jit_o0(lambda s: J.gramian_disc_factors(_JaxKernel(make_j(), tkern), s, max(8, d + 2)))(jnp.asarray(dts))
    _close(G.numpy(), want, 1e-10)
    _close(_gram(G).numpy(), Qs.numpy(), 1e-8)


def test_combines_are_associative():
    rng = np.random.RandomState(2)
    d, n = 4, 5

    def filt():
        tril = lambda x: torch.tril(torch.tensor(x))  # noqa: E731
        return S.SqrtFilteringElement(
            torch.tensor(rng.randn(n, d, d) * 0.5), torch.tensor(rng.randn(n, d)), tril(rng.randn(n, d, d) * 0.3),
            tril(rng.randn(n, d, d) * 0.3), torch.tensor(rng.randn(n, d)),
        )

    def smooth():
        return S.SqrtSmoothingElement(
            torch.tensor(rng.randn(n, d, d) * 0.5), torch.tensor(rng.randn(n, d)), torch.tril(torch.tensor(rng.randn(n, d, d) * 0.3))
        )

    for op, make, factors in ((S.sqrt_filtering_operator, filt, ("U", "Z")), (S.sqrt_smoothing_operator, smooth, ("N",))):
        e1, e2, e3 = make(), make(), make()
        left, right = op(op(e1, e2), e3), op(e1, op(e2, e3))
        for f in left._fields:
            a, b = getattr(left, f), getattr(right, f)
            if f in factors:
                a, b = _gram(a), _gram(b)
            npt.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("name", ["m52", "rbf12"])
def test_filter_smoother_lml_match_jax(name):
    """sqrt_pkf / sqrt_pks / sqrt_pkfs on the port's model and factors
    against the JAX engine on the same arrays: means and LML 1e-10,
    covariances through their factors' products 1e-9; and the kernel entry
    point equal to the composition."""
    make_j, make_t = KERNELS[name]
    tkern = make_t()
    t, y = _data(150, 3)
    lgssm, sqQ, sqP0 = _port_inputs(tkern, t)
    ys = torch.tensor(y)
    with torch.no_grad():
        fms, fUs, ell = S.sqrt_pkf(lgssm, ys, True, sqQ, sqP0)
        gms, gNs = S.sqrt_pks(lgssm, fms, fUs, sqQ)
        kms, kNs, kell = S.sqrt_pkfs_kernel(tkern, torch.tensor(t), NOISE, ys, True)
    jl = JLGSSM(*(jnp.asarray(x.numpy()) for x in lgssm))

    def ref(lg, obs, q, p0):
        m, U, ll = J.sqrt_pkf(lg, obs, True, q, p0)
        return m, U, ll, *J.sqrt_pks(lg, m, U, q)

    jm, jU, jell, jg, jN = jit_o0(ref)(jl, jnp.asarray(y).reshape(-1, 1), jnp.asarray(sqQ.numpy()), jnp.asarray(sqP0.numpy()))
    npt.assert_allclose(float(ell), float(jell), rtol=1e-10)
    _close(fms.numpy(), jm, 1e-10)
    _close(_gram(fUs).numpy(), _gram(jU), 1e-9)
    _close(gms.numpy(), jg, 1e-10)
    _close(_gram(gNs).numpy(), _gram(jN), 1e-9)
    npt.assert_allclose(float(kell), float(ell), rtol=1e-12)
    _close(kms.numpy(), gms.numpy(), 1e-12)
    _close(_gram(kNs).numpy(), _gram(gNs).numpy(), 1e-12)


def test_all_nan_series():
    """No observation: the LML is exactly 0.0, as the JAX engine's; the
    smoothed means are the prior's 0 and the covariances P0."""
    tkern = Matern52(0.9, 0.4, **F64)
    t = np.sort(np.random.RandomState(4).rand(40))
    y = np.full(40, np.nan)
    lgssm, sqQ, sqP0 = _port_inputs(tkern, t)
    with torch.no_grad():
        gms, gNs, ell = S.sqrt_pkfs(lgssm, torch.tensor(y), True, sqQ, sqP0)
    jell = jit_o0(lambda lg, q, p0: J.sqrt_pkf(lg, jnp.full((40, 1), jnp.nan), True, q, p0)[2])(
        JLGSSM(*(jnp.asarray(x.numpy()) for x in lgssm)), jnp.asarray(sqQ.numpy()), jnp.asarray(sqP0.numpy())
    )
    assert float(ell) == 0.0 and float(jell) == 0.0
    npt.assert_array_equal(gms.numpy(), np.zeros((40, 3)))
    _close(_gram(gNs).numpy(), np.broadcast_to(lgssm.P0.numpy(), (40, 3, 3)), 1e-10)


def test_chains_in_one_scan():
    """A model with a leading batch axis (C = 3 chains) gives each chain's
    results of a model without one."""
    ell = np.array([0.3, 0.4, 0.55])
    chains = Matern52(np.full(3, 0.9), ell, **F64)
    t, y = _data(130, 5)
    R = torch.tensor([0.1, 0.2, 0.15], dtype=torch.float64).reshape(3, 1, 1)
    with torch.no_grad():
        ms, Ns, lml = S.sqrt_pkfs_kernel(chains, torch.tensor(t), R, torch.tensor(y), True)
        assert tuple(ms.shape) == (3, 130, 3) and tuple(lml.shape) == (3,)
        for c in range(3):
            one = Matern52(0.9, float(ell[c]), **F64)
            m1, N1, l1 = S.sqrt_pkfs_kernel(one, torch.tensor(t), float(R[c]), torch.tensor(y), True)
            npt.assert_allclose(float(lml[c]), float(l1), rtol=1e-12)
            _close(ms[c].numpy(), m1.numpy(), 1e-11)
            _close(_gram(Ns[c]).numpy(), _gram(N1).numpy(), 1e-11)


def test_full_precision_restores_the_callers_setting():
    """Inside the engine float32 matmuls run at "highest"; the caller's
    setting comes back, also when the engine raises."""
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with S.full_precision():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
        with pytest.raises(RuntimeError):
            with S.full_precision():
                raise RuntimeError("inside")
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
