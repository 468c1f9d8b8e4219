"""PyTorch port vs the JAX package: the Padé matrix exponential
(ops/expm.py), RBF above order 8 through it, the matrix-fraction
discretisation, ``solve_right`` and the balancing-step setting; f64 on the
CPU unless named."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import config
from parallel_gps_torch.kernels import RBF, Matern32
from parallel_gps_torch.ops import disc, expm, linalg
from parallel_gps_tpu.ops import disc as jdisc
from parallel_gps_tpu.ops import expm as jexpm
from parallel_gps_tpu.ops import linalg as jlinalg
from _torch_common import jit_o0

torch.set_num_threads(1)


def _close(a, ref, rtol):
    """rtol against each entry, with an absolute floor of rtol times the
    largest entry."""
    ref = np.asarray(ref)
    npt.assert_allclose(np.asarray(a), ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _stable_F(d, seed):
    """A random F with eigenvalues in the left half-plane, entries spread
    over two orders of magnitude."""
    rng = np.random.RandomState(seed)
    M = rng.randn(d, d) * np.logspace(-1, 1, d)[:, None]
    return M - (np.abs(np.linalg.eigvals(M).real).max() + 0.5) * np.eye(d)


# Mixed step sizes: tiny ones (no scaling), moderate and large ones (up to
# 10+ squarings), and a zero step.
DTS = np.concatenate([[0.0, 1e-9, 1e-6, 3e-4], np.random.RandomState(7).rand(20) * 2.0, [40.0, 300.0]])


@pytest.mark.parametrize("d", [2, 6, 12, 15])
def test_pade_forms_match_jax(d):
    F = _stable_F(d, d)
    tF, tdts = torch.tensor(F), torch.tensor(DTS)
    jF, jdts = jnp.asarray(F), jnp.asarray(DTS)
    want = jit_o0(lambda f, s: (jexpm.expm1_dt_batched(f, s), jexpm.expm_dt_batched(f, s), jexpm.expm1_dt_tl(f, s)))(jF, jdts)
    got = (expm.expm1_dt_batched(tF, tdts), expm.expm_dt_batched(tF, tdts), expm.expm1_dt_tl(tF, tdts))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.numpy(), w, 1e-12)
    # A batch of C = 3 chains' F: (C, T, d, d) time-first, (d, d, C, T) time-last.
    Fs = torch.stack([tF, 0.5 * tF, 2.0 * tF])
    tl = expm.expm1_dt_tl(Fs, tdts)
    assert tuple(tl.shape) == (d, d, 3, DTS.size)
    for c in range(3):
        npt.assert_array_equal(tl[:, :, c].numpy(), expm.expm1_dt_tl(Fs[c], tdts).numpy())


@pytest.mark.parametrize("order", [3, 6])
def test_float32_no_overflow(order):
    """The solve is normalised by 1/b0: unnormalised, the adjugate's
    determinants (d ≤ 3) of O(b0) entries overflow float32 (JAX:
    tests/test_expm.py:81).  RBF's balanced F in f32 gives finite
    transitions within float32 rounding of the f64 ones."""
    F = RBF(1.0, 0.5, order=order, balancing_iter=10, dtype=torch.float64, device="cpu").get_sde().F.detach()
    dts = torch.tensor(np.diff(np.sort(np.random.RandomState(0).rand(512)) * 4.0, prepend=0.0))
    f32 = expm.expm1_dt_tl(F.float(), dts.float())
    assert bool(torch.isfinite(f32).all())
    _close(f32.double().numpy(), expm.expm1_dt_tl(F, dts).numpy(), 1e-4)


def test_rbf12_transitions_match_jax():
    """RBF(order=12) has no closed form in either package: its transitions
    are the Padé exponential of its balanced F, time-last and time-first,
    for one model and for chains."""
    jkern = jk.RBF(variance=1.3, lengthscales=0.37, order=12, balancing_iter=5)
    tkern = RBF(1.3, 0.37, order=12, balancing_iter=5, dtype=torch.float64, device="cpu")
    assert tkern.transition_coeffs() is None and jkern.transition_coeffs() is None
    dts = np.abs(np.random.RandomState(3).randn(50)) * 0.05
    # The balanced F is the JAX one's (test_torch_rbf_sde.py); the JAX
    # exponentials run on the port's.
    F = jnp.asarray(tkern.get_sde().F.detach().numpy())
    jtl, jtf = jit_o0(lambda f, s: (jexpm.expm1_dt_tl(f, s), jexpm.expm1_dt_batched(f, s)))(F, jnp.asarray(dts))
    with torch.no_grad():
        tl = tkern.transitions_m1_tl(torch.tensor(dts))
        tf = tkern.transitions_m1(torch.tensor(dts))
    _close(tl.numpy(), jtl, 1e-10)
    _close(tf.numpy(), jtf, 1e-10)
    chains = RBF(np.full(2, 1.3), np.array([0.37, 0.5]), order=12, balancing_iter=5, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        both = chains.transitions_m1_tl(torch.tensor(dts))
    assert tuple(both.shape) == (12, 12, 2, 50)
    npt.assert_allclose(both[:, :, 0].numpy(), tl.numpy(), rtol=0, atol=1e-13 * float(tl.abs().max()))


def test_discretize_mfd_and_solve_right():
    """The matrix-fraction discretisation against the JAX one and against
    the stationary ``discretize`` (the two must agree for a stationary P0);
    ``solve_right`` against the JAX one."""
    tk = Matern32(1.1, 0.4, dtype=torch.float64, device="cpu")
    jkern = jk.Matern32(variance=1.1, lengthscales=0.4)
    t = np.sort(np.random.RandomState(2).rand(60))
    R = np.array([[0.1]])
    with torch.no_grad():
        mfd = disc.discretize_mfd(tk.get_sde(), torch.tensor(t), torch.tensor(R))
        ref = tk.get_ssm(torch.tensor(t), torch.tensor(R))
    jmfd = jit_o0(lambda s: jdisc.discretize_mfd(jkern.get_sde(), s, jnp.asarray(R)))(jnp.asarray(t).reshape(-1, 1))
    for a, b, c in zip(mfd, jmfd, ref):
        _close(a.numpy(), b, 1e-11)
        _close(a.numpy(), c.numpy(), 1e-9)
    rng = np.random.RandomState(4)
    M = rng.randn(5, 4, 4) + 4.0 * np.eye(4)
    A = rng.randn(5, 3, 4)
    want = jit_o0(jlinalg.solve_right)(jnp.asarray(M), jnp.asarray(A))
    _close(linalg.solve_right(torch.tensor(M), torch.tensor(A)).numpy(), want, 1e-12)


def test_set_number_balancing_steps():
    """A kernel whose ``balancing_iter`` is negative reads the setting when it
    builds its SDE; one with its own count ignores it."""
    default = config.NUMBER_OF_BALANCING_STEPS
    try:
        config.set_number_balancing_steps(0)
        assert config.NUMBER_OF_BALANCING_STEPS == 0
        unbalanced = RBF(1.0, 0.5, order=4, dtype=torch.float64, device="cpu").get_sde().F
        own = RBF(1.0, 0.5, order=4, balancing_iter=10, dtype=torch.float64, device="cpu").get_sde().F
        config.set_number_balancing_steps(10)
        balanced = RBF(1.0, 0.5, order=4, dtype=torch.float64, device="cpu").get_sde().F
        npt.assert_array_equal(own.detach().numpy(), balanced.detach().numpy())
        assert not np.allclose(unbalanced.detach().numpy(), balanced.detach().numpy())
    finally:
        config.set_number_balancing_steps(default)
