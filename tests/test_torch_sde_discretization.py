"""PyTorch port vs the JAX package: discretization of Matérn models
(``get_ssm_tl`` and the dt-engine's planes), f64 on the CPU, same numpy
inputs."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_tpu.kalman.pallas_dt import build_planes_tl as j_build_planes_tl
from _torch_common import _np
from _torch_sde import IDS, KERNELS, _pair

torch.set_num_threads(1)


@pytest.mark.parametrize("name,v,ell", KERNELS, ids=IDS)
def test_discretization_matches_jax(name, v, ell):
    """get_ssm_tl and build_planes_tl (the plain dt-engine planes) vs JAX."""
    jkern, tkern = _pair(name, v, ell)
    ts = np.sort(np.random.RandomState(1).rand(64))
    j_ssm = jkern.get_ssm_tl(jnp.asarray(ts).reshape(-1, 1), jnp.asarray(0.05).reshape(1, 1))
    t_ssm = tkern.get_ssm_tl(torch.tensor(ts), torch.tensor([[0.05]], dtype=torch.float64))
    for field in ("P0", "Fs", "Qs", "H", "R"):
        npt.assert_allclose(
            _np(getattr(t_ssm, field)), _np(getattr(j_ssm, field)), rtol=1e-11, atol=1e-13, err_msg=field
        )
    j_coeffs, j_build = jkern.transition_coeffs()
    dts = np.diff(ts, prepend=0.0)
    jF, jQ, jP = j_build_planes_tl(j_build, j_coeffs, jkern.get_sde().P0, jnp.asarray(dts))
    family, t_coeffs = tkern.transition_coeffs()
    tF, tQ, tP = tdt.build_planes_tl(family, t_coeffs, tkern.get_sde().P0, torch.tensor(dts))
    for a, b in ((jF, tF), (jQ, tQ), (jP, tP)):
        npt.assert_allclose(_np(b), _np(a), rtol=1e-11, atol=1e-13)
