"""PyTorch port vs the JAX package: the batched path's kernels — B series (or
chains) at once.  The plain versions of the single-pass batched filter and
smoother (kalman/batched.py) against the JAX package's batched kernels in
interpret mode and against the single-series engine; shared (stride-0)
operands, the operand layouts the kernels are handed, and the wrappers'
refusals.  f64 on the CPU, same numpy inputs through both packages.
"""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import batched as tb
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_torch.types import LGSSMTL
from parallel_gps_tpu.kalman.pallas_scan import batched_strip_filter as jax_batched_filter
from parallel_gps_tpu.kalman.pallas_scan import batched_strip_smoother as jax_batched_smoother
from _torch_common import _no_compile_cache, port_model
from _torch_batched import _series, _t

torch.set_num_threads(1)


B, T, BLOCK = 9, 17, 16  # as tests/test_batched_pallas.py: more than 8 series; two time blocks, the second ragged


def _torch_planes(make, n, t):
    """Stacked planes and leaves of n port models with their own
    hyperparameters: (P0 (n,d,d), H (n,1,d), R (n,1,1), Fs, Qs (d,d,n,T))."""
    ssms = []
    with torch.no_grad():
        for i in range(n):
            R = torch.tensor([[0.1 + 0.02 * i]], dtype=torch.float64)
            ssms.append(make(0.5 + 0.3 * i, 0.2 + 0.1 * i).get_ssm_tl(_t(t), R))
    stack = lambda leaf, axis: torch.stack([getattr(s, leaf) for s in ssms], axis)  # noqa: E731
    return stack("P0", 0), stack("H", 0), stack("R", 0), stack("Fs", 2), stack("Qs", 2)


def _kernel_maker(d):
    if d <= 3:
        cls = {1: tk.Matern12, 2: tk.Matern32, 3: tk.Matern52}[d]
        return lambda v, ell: cls(v, ell, dtype=torch.float64, device="cpu")
    return lambda v, ell: tk.RBF(v, ell, order=d, dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def jax_batch():
    """One evaluation of the JAX batched kernels in interpret mode, as
    tests/test_batched_pallas.py runs them, shared by the assertions below,
    on the port kernels' models (``port_model``)."""
    t, ys = _series(B, T, 0)
    ssms = []
    for i in range(B):
        k = tk.Matern32(0.5 + i * 0.3, 0.2 + 0.1 * i, dtype=torch.float64, device="cpu")
        ssms.append(port_model(k, t, 0.1 + 0.02 * i)[0])
    Fs, Qs = (jnp.stack([getattr(s, n) for s in ssms], axis=2) for n in ("Fs", "Qs"))
    P0, H, R = (jnp.stack([getattr(s, n) for s in ssms]) for n in ("P0", "H", "R"))
    with _no_compile_cache():
        b, C, ell = jax_batched_filter(Fs, Qs, P0, H, R, jnp.asarray(ys), block=BLOCK, interpret=True)
        g, L, mean, var = jax_batched_smoother(Fs, Qs, b, C, H, block=BLOCK, interpret=True)
    inputs = tuple(_t(x) for x in (Fs, Qs, P0, H, R, ys))
    return inputs, tuple(np.asarray(x) for x in (b, C, ell, g, L, mean, var))


def test_plain_batched_filter_matches_the_jax_batched_kernel(jax_batch):
    (Fs, Qs, P0, H, R, ys), (b_j, C_j, ell_j, *_) = jax_batch
    b, C, ell = tb.batched_strip_filter(Fs, Qs, P0, H, R, ys)  # the CPU takes the plain version
    assert b.shape == (2, B, T) and C.shape == (2, 2, B, T) and ell.shape == (B,)
    # tests/test_batched_pallas.py:73-75
    npt.assert_allclose(b.numpy(), b_j, rtol=1e-9, atol=1e-11)
    npt.assert_allclose(C.numpy(), C_j, rtol=1e-9, atol=1e-11)
    npt.assert_allclose(ell.numpy(), ell_j, rtol=1e-10)


@pytest.mark.parametrize("project", [True, False], ids=["project", "moments"])
def test_plain_batched_smoother_matches_the_jax_batched_kernel(jax_batch, project):
    (Fs, Qs, _, H, _, _), (b_j, C_j, _, g_j, L_j, mean_j, var_j) = jax_batch
    out = tb.batched_strip_smoother(Fs, Qs, _t(b_j), _t(C_j), H if project else None, project=project)
    assert len(out) == (4 if project else 2)
    # tests/test_batched_pallas.py:76-86
    npt.assert_allclose(out[0].numpy(), g_j, rtol=1e-8, atol=1e-10)
    npt.assert_allclose(out[1].numpy(), L_j, rtol=1e-8, atol=1e-10)
    if project:
        npt.assert_allclose(out[2].numpy(), mean_j, rtol=1e-8)
        npt.assert_allclose(out[3].numpy(), var_j, rtol=1e-8)


@pytest.mark.parametrize("d", [1, 2, 3, 6])
def test_plain_batched_engine_matches_single_series(d):
    """Series i of the batched result against the single-series time-last
    engine on series i, at an odd T with NaNs (d = 6: RBF planes)."""
    n, T_odd = 5, 37
    t, ys = _series(n, T_odd, 10 + d)
    P0, H, R, Fs, Qs = _torch_planes(_kernel_maker(d), n, t)
    ys = _t(ys)
    b, C, ell = tb.batched_strip_filter_plain(Fs, Qs, P0, H, R, ys)
    g, L, mean, var = tb.batched_strip_smoother_plain(Fs, Qs, b, C, H)
    rf, af, rs, as_ = (1e-9, 1e-11, 1e-8, 1e-10) if d <= 3 else (1e-8, 1e-10, 1e-7, 1e-9)
    for i in range(n):
        ssm = LGSSMTL(P0[i], Fs[:, :, i], Qs[:, :, i], H[i], R[i])
        b_i, C_i, ell_i = ttl.pkf_from_tl(ssm, ys[i], True)
        g_i, L_i = ttl.pks_from_tl(ssm, b_i, C_i)
        npt.assert_allclose(b[:, i].numpy(), b_i.numpy(), rtol=rf, atol=af)
        npt.assert_allclose(C[:, :, i].numpy(), C_i.numpy(), rtol=rf, atol=af)
        npt.assert_allclose(float(ell[i]), float(ell_i), rtol=1e-10)
        npt.assert_allclose(g[:, i].numpy(), g_i.numpy(), rtol=rs, atol=as_)
        npt.assert_allclose(L[:, :, i].numpy(), L_i.numpy(), rtol=rs, atol=as_)
        h = H[i, 0]
        npt.assert_allclose(mean[i].numpy(), (h @ g_i).numpy(), rtol=rs, atol=as_)
        npt.assert_allclose(var[i].numpy(), torch.einsum("a,abt,b->t", h, L_i, h).numpy(), rtol=rs, atol=as_)


def test_shared_operands_equal_expanded_ones():
    """One model and n observation vectors (planes with batch stride 0), and
    one observation vector for n models: the bits of the expanded operands."""
    n, T_odd = 4, 33
    t, ys = _series(n, T_odd, 3)
    P0, H, R, Fs, Qs = _torch_planes(_kernel_maker(2), 1, t)
    shared = (Fs.expand(2, 2, n, T_odd), Qs.expand(2, 2, n, T_odd), P0.expand(n, 2, 2), H.expand(n, 1, 2), R.expand(n, 1, 1))
    assert shared[0].stride(2) == 0
    out_s = tb.batched_strip_filter(*shared, _t(ys))
    out_e = tb.batched_strip_filter(*(x.contiguous() for x in shared), _t(ys))
    for a, b_ in zip(out_s, out_e):
        assert torch.equal(a, b_)
    sm_s = tb.batched_strip_smoother(shared[0], shared[1], out_s[0], out_s[1], shared[3])
    sm_e = tb.batched_strip_smoother(shared[0].contiguous(), shared[1].contiguous(), out_e[0], out_e[1], shared[3].contiguous())
    for a, b_ in zip(sm_s, sm_e):
        assert torch.equal(a, b_)
    # One (T,) observation vector shared by n models.
    P0, H, R, Fs, Qs = _torch_planes(_kernel_maker(3), n, t)
    y_shared = tb.series_observations(_t(ys[0]), (n, T_odd))
    assert y_shared.shape == (n, T_odd) and y_shared.stride(0) == 0
    for a, b_ in zip(tb.batched_strip_filter(Fs, Qs, P0, H, R, y_shared), tb.batched_strip_filter(Fs, Qs, P0, H, R, y_shared.contiguous())):
        assert torch.equal(a, b_)


def test_kernel_operand_layouts():
    """What the wrappers hand the kernels: (tensor, plane stride, batch
    stride) — an expanded view as it is with batch stride 0, a view the
    kernels cannot address as a contiguous copy."""
    planes = torch.arange(2 * 2 * 7, dtype=torch.float64).reshape(2, 2, 1, 7)
    x, ps, bs = tb._strided(planes.expand(2, 2, 5, 7), 2)
    assert (ps, bs) == (7, 0) and x.data_ptr() == planes.data_ptr()
    x, ps, bs = tb._strided(torch.zeros(2, 2, 5, 7, dtype=torch.float64), 2)
    assert (ps, bs) == (35, 7)
    time_first = torch.zeros(7, 5, 2, 2, dtype=torch.float64).permute(2, 3, 1, 0)
    x, ps, bs = tb._strided(time_first, 2)
    assert x.is_contiguous() and (ps, bs) == (35, 7)
    y, _, bs = tb._strided(torch.zeros(7, dtype=torch.float64).reshape(1, 7).expand(5, 7), 0)
    assert bs == 0
    m, ps, bs = tb._strided(torch.zeros(3, 5, 7, dtype=torch.float64), 1)
    assert (ps, bs) == (35, 7)


def test_cuda_wrappers_refuse_other_devices_and_count_nothing_on_the_cpu():
    """A tensor off the CPU goes to the kernel wrapper, which refuses what it
    cannot launch instead of taking the plain version."""
    planes = torch.zeros(2, 2, 3, 9, device="meta", dtype=torch.float64)
    mom = torch.zeros(2, 3, 9, device="meta", dtype=torch.float64)
    leaves = [torch.zeros(s, device="meta", dtype=torch.float64) for s in ((3, 2, 2), (3, 1, 2), (3, 1, 1), (3, 9))]
    with pytest.raises(ValueError, match="CUDA device"):
        tb.batched_strip_filter(planes, planes, *leaves)
    with pytest.raises(ValueError, match="CUDA device"):
        tb.batched_strip_smoother(planes, planes, mom, planes, leaves[1])
    co = torch.zeros(3, 5, device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA device"):
        tdt.dt_fisher("exppoly", co, *leaves[:3], torch.zeros(9, device="meta", dtype=torch.float64), leaves[3], mom, planes, mom, planes)
    assert tb.LAUNCHES == {"batched_filter": 0, "batched_smoother": 0}
    assert tdt.LAUNCHES["dt_fisher"] == 0
