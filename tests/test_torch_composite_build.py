"""PyTorch port vs the JAX package: Periodic, Sum and Product — their SDEs,
their closed-form transitions and the composite transition family that the
dt engine rebuilds them from (kernels/composite.py) — and the engine a
composite model takes; f64 on the CPU.  The JAX builds run eagerly (its
balancing then runs on the host): compiled, each would cost seconds."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kernels.composite import COMPOSITE
from parallel_gps_torch.kernels.matern import build_transitions_m1
from parallel_gps_tpu.kalman.pallas_dt import build_planes_tl as jax_build_planes_tl
from _torch_common import _np
from _torch_composite import CPU64, composites, data, jax_spec, port_kernel, tk

torch.set_num_threads(1)

CASES = composites()


@pytest.mark.parametrize("name,jkern", CASES, ids=[n for n, _ in CASES])
def test_composite_build_matches_jax(name, jkern):
    """The composite family's rebuild of Am1 from its coefficients and the
    port's closed-form transitions against the JAX package's
    transition_coeffs() build, and — but for co2_shape, whose d = 10 SDE
    (a 100 × 100 Lyapunov solve) costs the JAX package 4 s to compile; its
    Sum and its Product are the two cases before it — the planes the dt
    engine rebuilds (F, Q, P0) and H against the JAX package's
    build_planes_tl (test_pallas_dt.py:124-126 tolerances)."""
    ts = np.sort(np.random.RandomState(2).rand(64))
    dts = np.diff(ts, prepend=0.0)
    coeffs, build = jkern.transition_coeffs()
    tkern = port_kernel(jkern)
    d = tkern.state_dim
    with torch.no_grad():
        fam, co = tkern.transition_coeffs()
        am1 = build_transitions_m1(fam, co, torch.tensor(dts), d)
        tl = tkern.transitions_m1_tl(torch.tensor(dts))
    assert fam == COMPOSITE and d == jkern.state_dim
    assert fam.plan.fits() == (d <= tdt.MAX_KERNEL_D[COMPOSITE])
    rows = build([coeffs[i] for i in range(coeffs.shape[0])], jnp.asarray(dts))
    ref = np.stack([np.stack([np.zeros(64) if e is None else _np(e) for e in row]) for row in rows])
    npt.assert_allclose(_np(am1), ref, rtol=1e-11, atol=1e-13)
    npt.assert_allclose(_np(tl), ref, rtol=1e-11, atol=1e-13)
    if name == "co2_shape":
        return
    sde = jkern.get_sde()
    Fs_j, Qs_j, P0_j = (_np(x) for x in jax_build_planes_tl(build, coeffs, sde.P0, jnp.asarray(dts)))
    with torch.no_grad():
        ssm = tkern.get_ssm_tl(torch.tensor(ts), torch.tensor([[0.05]], dtype=torch.float64))
        Fs_t, Qs_t, P0_t = tdt.build_planes_tl(fam, co, ssm.P0, torch.tensor(dts))
    for got in ((Fs_t, Qs_t, P0_t), (ssm.Fs, ssm.Qs, ssm.P0)):
        npt.assert_allclose(_np(got[0]), Fs_j, rtol=1e-11, atol=1e-13)
        npt.assert_allclose(_np(got[1]), Qs_j, rtol=1e-11, atol=1e-13)
        npt.assert_allclose(_np(got[2]), P0_j, rtol=1e-12, atol=1e-14)
    npt.assert_allclose(_np(ssm.H), _np(sde.H), rtol=1e-12, atol=1e-14)


TRANSITIONS = [
    ("periodic3", jk.Periodic(1.2, 0.7, 1.3, order=3)),
    ("m32_plus_m52", jk.Matern32(1.0, 0.5) + jk.Matern52(0.8, 0.4)),
    ("periodic2_times_m32", jk.Periodic(1.0, 0.5, 1.0, order=2) * jk.Matern32(1.0, 0.5)),
]
# test_kernels.py:143-144's CO2 composite, d = 18 (its time-last engine is
# test_torch_composite_qp.py's).
CO2 = jk.Periodic(1.0, 0.5, 1.0, order=3) * jk.Matern32(1.0, 0.5) + jk.Matern32(0.5, 2.0)


@pytest.mark.parametrize("name,jkern", TRANSITIONS, ids=[n for n, _ in TRANSITIONS])
def test_time_last_transitions_match_jax(name, jkern):
    """The closed-form time-last transitions (the children's, folded and
    balanced) of test_kernels.py:139-141's kernels against the JAX
    package's, and, where the dt kernels take them (d ≤ 8), the composite
    family's rebuild of them from its coefficients."""
    dts = np.abs(np.random.RandomState(0).rand(64)) * 0.01 + 1e-5
    ref = _np(jkern.transitions_m1_tl(jnp.asarray(dts)))
    tkern = port_kernel(jkern)
    with torch.no_grad():
        got = tkern.transitions_m1_tl(torch.tensor(dts))
        npt.assert_allclose(_np(got), ref, rtol=1e-11, atol=1e-13)
        fam, co = tkern.transition_coeffs()
        if tkern.state_dim <= tdt.MAX_KERNEL_D[COMPOSITE]:
            npt.assert_allclose(_np(build_transitions_m1(fam, co, torch.tensor(dts), tkern.state_dim)), ref, rtol=1e-11, atol=1e-13)


def test_engine_routes_composites_and_specs_round_trip():
    """A composite of closed-form leaves takes the dt engine with the
    composite family up to d = 8 and the plain time-last engine above (the
    d = 14 Periodic(order=6), the d = 18 CO2 composite); with a batch axis
    it gives one LML a chain, each the scalar model's; to_numpy returns the spec that
    from_numpy takes, and the JAX kernel tree's spec builds the same
    kernel."""
    t, y = data(40, 0)
    specs = [jax_spec(k) for _, k in CASES + TRANSITIONS + [("co2_d18", CO2)]]
    for spec in specs:
        m = StateSpaceGP.from_numpy(t, y, spec, noise_variance=0.1, **CPU64)
        engine, transition = m.engine()
        want = "dt" if m.kernel.state_dim <= 8 else "timelast"
        assert engine == want and (transition is None or transition[0] == COMPOSITE), (spec[0], m.kernel.state_dim, engine)
        back = m.to_numpy()
        again = StateSpaceGP.from_numpy(t, y, back["kernel"], noise_variance=back["noise_variance"], **CPU64)
        for (n1, p1), (n2, p2) in zip(m.named_parameters(), again.named_parameters()):
            assert n1 == n2
            npt.assert_allclose(_np(p2), _np(p1), rtol=1e-14)
    assert StateSpaceGP.from_numpy(t, y, jax_spec(CO2), noise_variance=0.1, **CPU64).kernel.state_dim == 18
    k = tk.Periodic(np.full(3, 1.0), 0.5, 1.0, order=1, **CPU64) * tk.Matern32(1.0, 0.5, **CPU64)
    chains = StateSpaceGP.create((t, y), k, 0.1, **CPU64)
    one = StateSpaceGP.create((t, y), tk.Periodic(1.0, 0.5, 1.0, order=1, **CPU64) * tk.Matern32(1.0, 0.5, **CPU64), 0.1, **CPU64)
    lml = chains.log_marginal_likelihood().detach()
    assert chains.engine()[0] == "dt" and lml.shape == (3,)
    npt.assert_allclose(lml.numpy(), np.full(3, float(one.log_marginal_likelihood().detach())), rtol=1e-12)
