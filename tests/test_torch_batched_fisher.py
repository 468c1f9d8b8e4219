"""PyTorch port: the batch axis of the Fisher tail, of ``pkfs_dt``, of
``lml_dt`` and of ``lml_tl(strip=True)`` against loops over single series,
gradients included.  f64 on the CPU.
"""
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kalman import timelast as ttl
from parallel_gps_torch.types import LGSSMTL
from _torch_batched import C_CHAINS, ELL, MATERN, NOISE, VAR, _data, _series, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("name,d", MATERN, ids=["m12", "m32", "m52"])
@pytest.mark.parametrize("shared_y", [True, False], ids=["chains", "series"])
def test_batched_fisher_plain_matches_single_series(name, d, shared_y):
    """``dt_fisher_plain`` with a batch axis — shared dts, shared or
    per-series y — against the single-series call per series."""
    T_ = 61
    t, ys = _series(C_CHAINS, T_, 5)
    y_b = _t(ys[0]) if shared_y else _t(ys)
    k = getattr(tk, name)(VAR, ELL, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        fam, co = k.transition_coeffs()
        co, P0, H, R, batched = tdt.series_inputs(co, k.get_sde(), _t(NOISE))
        assert batched
        dts = tdt._dts_from_ts(_t(t))
        b, C, _ = tdt.strip_filter_dt(fam, co, P0, H, R, dts, y_b)
        g, L = tdt.strip_smoother_dt(fam, co, P0, dts, b, C)
        assert b.shape == (d, C_CHAINS, T_) and L.shape == (d, d, C_CHAINS, T_)
        out_b = tdt.dt_fisher(fam, co, P0, H, R, dts, y_b, b, C, g, L)  # the CPU takes the plain version
        for c in range(C_CHAINS):
            y_c = y_b if shared_y else y_b[c]
            out = tdt.dt_fisher_plain(fam, co[c], P0[c], H[c], R[c], dts, y_c, b[:, c], C[:, :, c], g[:, c], L[:, :, c])
            for a, ref in zip(out_b, out):
                assert a[c].shape == ref.shape
                npt.assert_allclose(a[c].numpy(), ref.numpy(), rtol=1e-10, atol=1e-12)


def test_batched_pkfs_dt_and_lml_gradient_in_the_observations():
    """``pkfs_dt`` on batched hyperparameters returns (d, B, T) moments, each
    series the single model's; the LML's gradient in shared observations is
    the sum over the chains."""
    t, y = _data(90, 9)
    kb = tk.Matern32(VAR, ELL, dtype=torch.float64, device="cpu")
    yt = _t(y).requires_grad_()
    with torch.no_grad():
        g, L = tdt.pkfs_dt(kb, _t(t), _t(NOISE), yt)
    assert g.shape == (2, C_CHAINS, 90) and L.shape == (2, 2, C_CHAINS, 90)
    lml = tdt.lml_dt(kb, _t(t), _t(NOISE), yt)
    (dy,) = torch.autograd.grad(lml.sum(), yt)
    total = torch.zeros_like(dy)
    for c in range(C_CHAINS):
        ks = tk.Matern32(VAR[c], ELL[c], dtype=torch.float64, device="cpu")
        R = torch.tensor([[NOISE[c]]], dtype=torch.float64)
        with torch.no_grad():
            g_c, L_c = tdt.pkfs_dt(ks, _t(t), R, _t(y))
        npt.assert_allclose(g[:, c].numpy(), g_c.numpy(), rtol=1e-8, atol=1e-10)
        npt.assert_allclose(L[:, :, c].numpy(), L_c.numpy(), rtol=1e-8, atol=1e-10)
        y_c = _t(y).requires_grad_()
        total += torch.autograd.grad(tdt.lml_dt(ks, _t(t), R, y_c), y_c)[0]
    npt.assert_allclose(dy.numpy(), total.numpy(), rtol=1e-8, atol=1e-12)


def test_batched_lml_tl_on_one_model_and_many_observation_vectors():
    """``lml_tl(strip=True)`` on planes with a batch axis — one Matern32 model
    shared by n observation vectors through stride-0 planes — against n single
    calls: values, and gradients in the observations and in P0."""
    n, T_ = 6, 77
    t, ys = _series(n, T_, 11)
    with torch.no_grad():
        ssm = tk.Matern32(1.0, 0.5, dtype=torch.float64, device="cpu").get_ssm_tl(_t(t), torch.tensor([[0.1]], dtype=torch.float64))
    P0 = ssm.P0.expand(n, 2, 2).clone().requires_grad_()
    ys_b = _t(ys).requires_grad_()
    shared = LGSSMTL(P0, ssm.Fs[:, :, None].expand(2, 2, n, T_), ssm.Qs[:, :, None].expand(2, 2, n, T_), ssm.H.expand(n, 1, 2), ssm.R.expand(n, 1, 1))
    lml = ttl.lml_tl(shared, ys_b, strip=True)
    assert lml.shape == (n,)
    d_y, d_P0 = torch.autograd.grad(lml.sum(), (ys_b, P0))
    for i in range(n):
        y_i, P0_i = _t(ys[i]).requires_grad_(), ssm.P0.clone().requires_grad_()
        ref = ttl.lml_tl(LGSSMTL(P0_i, ssm.Fs, ssm.Qs, ssm.H, ssm.R), y_i, strip=True)
        r_y, r_P0 = torch.autograd.grad(ref, (y_i, P0_i))
        npt.assert_allclose(float(lml[i].detach()), float(ref.detach()), rtol=1e-10)
        npt.assert_allclose(d_y[i].numpy(), r_y.numpy(), rtol=1e-8, atol=1e-12)
        npt.assert_allclose(d_P0[i].numpy(), r_P0.numpy(), rtol=1e-8, atol=1e-12)
