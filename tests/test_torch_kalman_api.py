"""PyTorch port vs the JAX package: the Kalman API on an explicit state-space
model — ``lgssm_from_numpy``, the sequential oracle (kf / ks / kfs), the
reference-literal generic engine with two observation rows and its blocked
scan, the dispatch's refusals — and the port's imports and documented drives;
f64 on the CPU."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import kernels as tk
from parallel_gps_torch import LGSSM, LGSSMTL, lgssm_from_numpy
from parallel_gps_torch.kalman import kf, kfs, ks, pkf, pkfs, pks
from parallel_gps_tpu.kalman import parallel as jpar
from parallel_gps_tpu.kalman import sequential as jseq
from parallel_gps_tpu.types import LGSSM as JaxLGSSM
from _torch_common import _np, jit_o0, port_model
from _torch_kalman import FILTER_TOL, SMOOTHER_TOL, _port, m52, rbf4  # noqa: F401 (m52, rbf4: fixtures)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def m2_problem():
    """A d = 3 model with two observation rows (tests/test_multiobs.py): P0 is
    the stationary covariance, so that the parallel engine's first element
    and the sequential engine's first prediction agree."""
    from scipy.linalg import solve_discrete_lyapunov

    rng = np.random.RandomState(7)
    d, m, T = 3, 2, 61
    A = rng.randn(d, d)
    A = 0.9 * A / np.abs(np.linalg.eigvals(A)).max()
    Qw = rng.randn(d, d)
    Q = 0.3 * Qw @ Qw.T + 0.1 * np.eye(d)
    H = rng.randn(m, d)
    Rw = rng.randn(m, m)
    R = 0.2 * Rw @ Rw.T + 0.05 * np.eye(m)
    ys = rng.randn(T, m)
    ys[5] = np.nan
    ys[17, 1] = np.nan  # one NaN component: the whole step counts as missing
    arrays = (solve_discrete_lyapunov(A, Q), np.broadcast_to(A, (T, d, d)).copy(), np.broadcast_to(Q, (T, d, d)).copy(), H, R)
    return JaxLGSSM(*(jnp.asarray(x) for x in arrays)), jnp.asarray(ys), _port(arrays, False), torch.tensor(ys)


def test_lgssm_from_numpy_layouts(m52):
    tf, tl, _, ttf, ttl_, _ = m52
    assert isinstance(ttf, LGSSM) and isinstance(ttl_, LGSSMTL)
    assert ttf.Fs.shape == (150, 3, 3) and ttl_.Fs.shape == (3, 3, 150)
    for x in (*ttf, *ttl_):
        assert x.dtype == torch.float64 and x.device.type == "cpu"
    with pytest.raises(ValueError, match="time_last=True"):
        _port(tf, True)


@pytest.mark.parametrize("problem", ["m52", "rbf4", "m2"])
def test_sequential_engine_matches_jax(problem, request):
    """kf (with likelihood and predicted moments), ks and kfs."""
    if problem == "m2":
        jssm, ys, tssm, ty = request.getfixturevalue("m2_problem")
    else:
        jssm, _, ys, tssm, _, ty = request.getfixturevalue(problem)
    (fms_j, fPs_j, ell_j, mps_j, Pps_j), (sms_j, sPs_j) = jit_o0(lambda s, y: (jseq.kf(s, y, True, True), jseq.kfs(s, y)))(jssm, ys)
    fms, fPs, ell, mps, Pps = kf(tssm, ty, return_loglikelihood=True, return_predicted=True)
    assert len(kf(tssm, ty)) == 2 and len(kf(tssm, ty, return_predicted=True)) == 4
    for a, ref in ((fms, fms_j), (fPs, fPs_j), (mps, mps_j), (Pps, Pps_j)):
        npt.assert_allclose(_np(a), _np(ref), **FILTER_TOL)
    npt.assert_allclose(float(ell), float(ell_j), rtol=1e-10)
    for sms, sPs in (ks(tssm, fms, fPs, mps, Pps), kfs(tssm, ty)):
        npt.assert_allclose(_np(sms), _np(sms_j), **SMOOTHER_TOL)
        npt.assert_allclose(_np(sPs), _np(sPs_j), **SMOOTHER_TOL)


def test_generic_engine_with_two_observation_rows(m2_problem):
    """The reference-literal (m, m)-solve algebra (tests/test_multiobs.py):
    "auto" must pick the generic engine for m > 1."""
    jssm, ys, tssm, ty = m2_problem
    (fms_j, fPs_j, ell_j), (sms_j, sPs_j) = jit_o0(
        lambda s, y: (jpar.pkf(s, y, True, engine="generic"), jpar.pkfs(s, y, engine="generic"))
    )(jssm, ys)
    for engine in ("generic", "auto"):
        fms, fPs, ell = pkf(tssm, ty, return_loglikelihood=True, engine=engine)
        sms, sPs = pkfs(tssm, ty, engine=engine)
        npt.assert_allclose(_np(fms), _np(fms_j), **FILTER_TOL)
        npt.assert_allclose(_np(fPs), _np(fPs_j), **FILTER_TOL)
        npt.assert_allclose(float(ell), float(ell_j), rtol=1e-10)
        npt.assert_allclose(_np(sms), _np(sms_j), **SMOOTHER_TOL)
        npt.assert_allclose(_np(sPs), _np(sPs_j), **SMOOTHER_TOL)
    # The sequential oracle agrees with it on the same model.
    npt.assert_allclose(float(kf(tssm, ty, True)[2]), float(ell), rtol=1e-10)


def test_blocked_scan_of_the_generic_engine(m52):
    """T ≥ 256 takes the two-level scan (ops/scan.py), with a ragged last
    block; sequential vs parallel LML < 1e-10 relative."""
    rng = np.random.RandomState(1)
    T = 300
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[::9] = np.nan
    ssm, _ = port_model(tk.Matern32(1.0, 0.5, dtype=torch.float64, device="cpu"), t, 0.1, time_last=False)
    tssm, ty = _port(ssm, False), torch.tensor(y)
    _, _, ell_seq = kf(tssm, ty, True)
    sms_seq, sPs_seq = kfs(tssm, ty)
    for engine in ("generic", "timelast"):
        _, _, ell = pkf(tssm, ty, True, engine=engine)
        assert abs(float(ell) - float(ell_seq)) < 1e-10 * abs(float(ell_seq))
        sms, sPs = pkfs(tssm, ty, engine=engine)
        npt.assert_allclose(_np(sms), _np(sms_seq), **SMOOTHER_TOL)
        npt.assert_allclose(_np(sPs), _np(sPs_seq), **SMOOTHER_TOL)


def test_dispatch_refuses_what_an_engine_cannot_do(m52, m2_problem):
    _, _, _, ttf, ttl_, ty = m52
    _, _, m2, ty2 = m2_problem
    with pytest.raises(ValueError, match='engine="strip"'):
        pkf(ttl_, ty, engine="pallas")
    with pytest.raises(ValueError, match="unknown engine"):
        pkfs(ttf, ty, engine="fast")
    with pytest.raises(ValueError, match="time-first"):
        pkf(ttl_, ty, engine="generic")
    for engine in ("timelast", "strip"):
        with pytest.raises(ValueError, match="scalar observations only"):
            pkf(m2, ty2, engine=engine)
        with pytest.raises(ValueError, match="scalar observations only"):
            pks(m2, *kf(m2, ty2), engine=engine)
    # A time-first model with engine="strip" runs the plane scan
    # (kalman/plane.py) and matches the time-last engine.
    sms, sPs = pkfs(ttf, ty, engine="strip")
    sms_tl, sPs_tl = pkfs(ttf, ty, engine="timelast")
    npt.assert_allclose(_np(sms), _np(sms_tl), **SMOOTHER_TOL)
    npt.assert_allclose(_np(sPs), _np(sPs_tl), **SMOOTHER_TOL)
    d = 9
    eye = np.eye(d)
    big = lgssm_from_numpy(eye, 0.5 * eye[:, :, None].repeat(4, -1), 0.75 * eye[:, :, None].repeat(4, -1), eye[:1], [[0.1]], time_last=True, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="d <= 8"):
        pkf(big, torch.zeros(4, dtype=torch.float64), engine="strip")
    fms, _ = pkf(big, torch.zeros(4, dtype=torch.float64))  # "auto": plain time-last, any d
    assert fms.shape == (4, 9)


def test_lgssm_from_numpy_goes_to_the_card_by_default():
    """``device=None`` is the card, and raises without one instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lgssm_from_numpy(np.eye(1), np.ones((1, 1, 3)), np.ones((1, 1, 3)), np.ones((1, 1)), np.ones((1, 1)), time_last=True)


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    """Every import statement of the port's modules and of chip_smoke.py, read
    from the source: none names jax, flax, optax or parallel_gps_tpu."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "parallel_gps_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 20
    foreign = {"jax", "jaxlib", "flax", "optax", "parallel_gps_tpu"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert not {n.split(".")[0] for n in names} & foreign, f"{path} imports {names}"


def test_documented_drives_load_no_jax_and_launch_nothing_on_the_cpu():
    """The canonical drive (its optimiser step is the fresh-interpreter
    drive of test_torch_dt_dispatch.py), the RBF model drive and the
    Kalman-API drive of the README, at T = 40, in a fresh interpreter on the
    CPU: jax and the JAX package
    stay unloaded, no launch counter moves and the CUDA loader is never
    imported."""
    import json
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(
        """
        import json, sys
        import numpy as np, torch
        from parallel_gps_torch import StateSpaceGP
        from parallel_gps_torch.kalman import pkfs, dt, strip
        from parallel_gps_torch.kernels import Matern52
        from parallel_gps_torch.toymodels import sinu, obs_noise
        t = np.sort(np.random.RandomState(0).rand(40)); y = obs_noise(sinu(t), 0.1, 1)
        m = StateSpaceGP.from_numpy(t, y, "Matern32", 2.0, 1.0, 0.5, dtype=torch.float64, device="cpu")
        m.predict_f(np.linspace(0.02, 0.98, 5))
        rbf = StateSpaceGP.from_numpy(t, y, "RBF", 1.0, 0.3, 0.1, dtype=torch.float64, device="cpu", order=6)
        rbf.training_loss().backward(); rbf.predict_f(np.linspace(0.02, 0.98, 5))
        k = Matern52(0.8, 0.4, dtype=torch.float64, device="cpu")
        with torch.no_grad():
            sms, sPs = pkfs(k.get_ssm_tl(torch.tensor(t), torch.tensor([[0.1]], dtype=torch.float64)), torch.tensor(y), engine="strip")
        foreign = ("jax", "jaxlib", "flax", "optax", "parallel_gps_tpu")
        print(json.dumps({
            "foreign": sorted(m for m in sys.modules if m.split(".")[0] in foreign),
            "launches": {**dt.LAUNCHES, **strip.LAUNCHES},
            "cuda_loader_imported": "parallel_gps_torch.kalman._cuda" in sys.modules,
            "engine": rbf.engine()[0], "shapes": [list(sms.shape), list(sPs.shape)],
        }))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    facts = json.loads(out.stdout.strip().splitlines()[-1])
    assert facts["foreign"] == []
    assert len(facts["launches"]) == 19 and set(facts["launches"].values()) == {0}
    assert not facts["cuda_loader_imported"]
    assert facts["engine"] == "dt" and facts["shapes"] == [[40, 3], [40, 3, 3]]
