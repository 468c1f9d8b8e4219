"""PyTorch port vs the JAX package: every route of the dispatching pkf / pks /
pkfs, for both layouts of an explicit model built through
``lgssm_from_numpy``, against the JAX package's parallel engines; f64 on the
CPU."""
import jax
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch.kalman import pkf, pkfs, pks
from parallel_gps_tpu.kalman import parallel as jpar
from _torch_common import _np
from _torch_kalman import FILTER_TOL, SMOOTHER_TOL, m52, rbf4  # noqa: F401 (m52, rbf4: fixtures)

torch.set_num_threads(1)


# (problem, layout, port engine, JAX engine): every route of the dispatch.
ROUTES = [
    ("m52", "tf", "auto", "auto"),  # d ≤ 3: time-last engine under the hood
    ("m52", "tf", "timelast", "timelast"),
    ("m52", "tf", "generic", "generic"),
    ("m52", "tl", "auto", "auto"),
    ("m52", "tl", "timelast", "timelast"),
    ("m52", "tl", "strip", "auto"),  # JAX "pallas" needs a TPU; same moments
    ("rbf4", "tf", "auto", "auto"),  # d > 3: generic engine, LU solves
    ("rbf4", "tf", "timelast", "timelast"),
    ("rbf4", "tl", "auto", "auto"),
    ("rbf4", "tl", "strip", "auto"),
]


@pytest.mark.parametrize("problem,layout,engine,jax_engine", ROUTES, ids=["-".join(r[:3]) for r in ROUTES])
def test_parallel_engines_match_jax(problem, layout, engine, jax_engine, request):
    """pkf (with likelihood), pks on its moments and pkfs, for both layouts
    of the model; outputs are time-first in every case."""
    tf, tl, ys, ttf, ttl_, ty = request.getfixturevalue(problem)
    jssm, tssm = (tf, ttf) if layout == "tf" else (tl, ttl_)
    fms_j, fPs_j, ell_j = jax.jit(lambda s, y: jpar.pkf(s, y, True, engine=jax_engine))(jssm, ys)
    sms_j, sPs_j = jax.jit(lambda s, y: jpar.pkfs(s, y, engine=jax_engine))(jssm, ys)
    fms, fPs, ell = pkf(tssm, ty, return_loglikelihood=True, engine=engine)
    assert fms.shape == (ty.shape[0], tssm.P0.shape[0]) and len(pkf(tssm, ty, engine=engine)) == 2
    npt.assert_allclose(_np(fms), _np(fms_j), **FILTER_TOL)
    npt.assert_allclose(_np(fPs), _np(fPs_j), **FILTER_TOL)
    npt.assert_allclose(float(ell), float(ell_j), rtol=1e-10)
    for sms, sPs in (pks(tssm, fms, fPs, engine=engine), pkfs(tssm, ty, engine=engine)):
        npt.assert_allclose(_np(sms), _np(sms_j), **SMOOTHER_TOL)
        npt.assert_allclose(_np(sPs), _np(sPs_j), **SMOOTHER_TOL)
