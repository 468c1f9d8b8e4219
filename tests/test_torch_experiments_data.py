"""PyTorch port vs the JAX package: what the experiments read and build —
the datasets and the toy-model data, every covariance of the factory as an
SDE, the sunspot priors, and the positions' transforms.  f64 on the CPU;
the JAX side runs eagerly (no jit)."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import datasets as tdata
from parallel_gps_torch.experiments import common as TC
from parallel_gps_torch.experiments.sunspot import common as tsun
from parallel_gps_torch.experiments.toy_models.common import get_data as t_toy_data
from parallel_gps_torch.models import StateSpaceGP
from parallel_gps_torch.models import params as tparams
from parallel_gps_torch.misc_utils import rmse as t_rmse
from parallel_gps_tpu import datasets as jdata
from parallel_gps_tpu.experiments import common as JC
from parallel_gps_tpu.experiments.sunspot import common as jsun
from parallel_gps_tpu.experiments.toy_models.common import get_data as j_toy_data
from parallel_gps_tpu.misc_utils import rmse as j_rmse
from parallel_gps_tpu.models import params as jparams
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_defaults():
    """``set_dtype`` sets torch's default float and the models' device for the
    process: put both back for the tests that follow."""
    dtype, device = torch.get_default_dtype(), TC._DEVICE[0]
    yield
    torch.set_default_dtype(dtype)
    TC._DEVICE[0] = device


def test_datasets_and_toy_data_equal_the_jax_packages():
    """The loaders read the repo's data/ into the JAX package's arrays, bit
    for bit; the toy-model data of every function and the rmse likewise."""
    for n in (None, 50, 3200):
        for a, b in zip(tdata.load_sunspots(n), jdata.load_sunspots(n)):
            npt.assert_array_equal(a, b)
    for n in (None, 100):
        for a, b in zip(tdata.load_co2(n), jdata.load_co2(n)):
            npt.assert_array_equal(a, b)
    for kind in ("SINE", "composite_sine", "RECT"):
        for a, b in zip(t_toy_data(3, 64, 37, kind, 0.5), j_toy_data(3, 64, 37, kind, 0.5)):
            npt.assert_array_equal(a, b)
    x, y = np.linspace(0, 1, 9), np.cos(np.arange(9.0))
    assert t_rmse(torch.tensor(x), y) == j_rmse(x, y)


@pytest.mark.parametrize("kind", [c.value for c in JC.CovarianceEnum])
def test_every_covariance_builds_the_jax_factorys_sde(kind):
    """``get_covariance_function`` of every ``CovarianceEnum`` (RBF at order
    4, QP at --qp-order 1) gives the SDE (F, L, H, Q, P∞) of the JAX
    factory's kernel: rtol 1e-10."""
    opts = dict(variance=1.3, lengthscales=0.4, rbf_order=4, rbf_balance_iter=10, qp_order=1)
    assert TC.set_dtype("float64", "cpu") == torch.device("cpu") and torch.get_default_dtype() == torch.float64
    tk = TC.get_covariance_function(kind, **opts)
    jkern = JC.get_covariance_function(kind, **opts)
    with torch.no_grad():
        sde = tk.get_sde()
    jsde = jkern.get_sde()
    assert tk.state_dim == jkern.state_dim
    for name, a, b in zip(("P0", "F", "L", "H", "Q"), sde, jsde):
        npt.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape), rtol=1e-10, atol=1e-12, err_msg=name)


def test_sunspot_priors_log_densities_equal_the_jax_packages():
    """The sunspot priors (constrained-space Normals with the log-Jacobian)
    on the same unconstrained values give the JAX package's log prior."""
    t, y = jsun.get_data(40)
    TC.set_dtype("float64", "cpu")
    tm = StateSpaceGP.create((t, y), tsun.get_covariance_function(), 300.0, device="cpu")
    jm = JaxStateSpaceGP.create((t, y), jsun.get_covariance_function(), noise_variance=300.0)
    for shift in (0.0, 0.7, -1.3):
        ju = jparams.unconstrain({"kernel": jm.kernel, "noise_variance": jm.noise_variance})
        ju = {"kernel": ju["kernel"].replace(variance=ju["kernel"].variance + shift), "noise_variance": ju["noise_variance"] - shift}
        want = float(jparams.log_prior(ju, jsun.get_priors(300.0)))
        u = tparams.positions_from_tree(ju, tm)
        got = float(tparams.log_prior(u, tsun.get_priors(300.0)))
        npt.assert_allclose(got, want, rtol=1e-13)


def test_unconstrain_constrain_and_as_arrays_equal_the_jax_packages():
    """The transforms of the port's flat positions against the JAX package's
    on the same tree: positive leaves through softplus⁻¹ and back, others
    untouched, and every leaf of the default float."""
    values = {"kernel.variance": 2.5, "kernel.kernels.0.period": 0.7, "kernel.kernels.1.lengthscales": 1e-3,
              "noise_variance": 0.2, "kernel.mean": -1.5}
    tree = {"kernel": {"variance": 2.5, "kernels": ({"period": 0.7}, {"lengthscales": 1e-3}), "mean": -1.5}, "noise_variance": 0.2}
    ju = jparams.unconstrain(jparams.as_arrays(tree, jnp.float64))
    tu = tparams.unconstrain(tparams.as_arrays(values, torch.float64, "cpu"))
    assert set(tu) == {"kernel.raw_variance", "kernel.kernels.0.raw_period", "kernel.kernels.1.raw_lengthscales",
                       "raw_noise_variance", "kernel.mean"}
    pairs = {"kernel.raw_variance": ju["kernel"]["variance"], "kernel.kernels.0.raw_period": ju["kernel"]["kernels"][0]["period"],
             "kernel.kernels.1.raw_lengthscales": ju["kernel"]["kernels"][1]["lengthscales"],
             "raw_noise_variance": ju["noise_variance"], "kernel.mean": ju["kernel"]["mean"]}
    for name, want in pairs.items():
        npt.assert_allclose(tu[name].numpy(), np.asarray(want), rtol=1e-15, err_msg=name)
    back = tparams.constrain(tu)
    jback = jparams.constrain(ju)
    npt.assert_allclose(back["kernel.kernels.1.lengthscales"].numpy(), np.asarray(jback["kernel"]["kernels"][1]["lengthscales"]), rtol=1e-15)
    for name, v in values.items():
        npt.assert_allclose(back[name].numpy(), v, rtol=1e-12, err_msg=name)
    torch.set_default_dtype(torch.float32)
    as32 = tparams.as_arrays({"a": np.float64(1.5), "b": {"c": torch.ones(2, dtype=torch.float64)}}, device="cpu")
    assert as32["a"].dtype == torch.float32 and as32["b"]["c"].dtype == torch.float32
    assert jparams.as_arrays({"a": 1.5}, jnp.float32)["a"].dtype == jnp.float32
