"""The port's experiment CLIs at tiny sizes on the CPU (``--platform cpu``):
each writes the file names and array names that the JAX CLI writes (its
``main`` run with the model work stubbed out, so that nothing compiles);
the JAX package's ``load_samples`` reads a sample file the port wrote, and
the port's one that the JAX CLI wrote; ``--plot`` names ROADMAP A12b;
``--stable`` runs the sweep on the square-root engine."""
import sys

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

import parallel_gps_tpu.inference as jinference
from parallel_gps_torch.experiments import common as TC
from parallel_gps_torch.experiments.sunspot import map as tmap
from parallel_gps_torch.experiments.sunspot import mcmc as tmcmc
from parallel_gps_torch.experiments.sunspot import speed_and_stability as tsun_speed
from parallel_gps_torch.experiments.toy_models import mcmc as ttoy_mcmc
from parallel_gps_torch.experiments.toy_models import speed_and_stability as ttoy_speed
from parallel_gps_tpu.experiments import common as JC
from parallel_gps_tpu.experiments.sunspot import map as jmap
from parallel_gps_tpu.experiments.sunspot import mcmc as jmcmc
from parallel_gps_tpu.experiments.toy_models import mcmc as jtoy_mcmc
from parallel_gps_tpu.experiments.toy_models import speed_and_stability as jtoy_speed
from parallel_gps_tpu.models import StateSpaceGP as JaxStateSpaceGP
from parallel_gps_tpu.models.params import unconstrain as jax_unconstrain

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_defaults():
    """The CLIs set torch's default float and the models' device for the
    process: put both back for the tests that follow."""
    dtype, device = torch.get_default_dtype(), TC._DEVICE[0]
    yield
    torch.set_default_dtype(dtype)
    TC._DEVICE[0] = device


def _main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


class _Stub:
    """A JAX model whose prediction is zeros: the JAX CLIs' saving code runs
    without a compile."""

    def __init__(self, tree):
        self.tree = tree

    def predict_f(self, X):
        z = np.zeros((np.shape(X)[0], 1))
        return z, z


def _stub_jax(monkeypatch, n_samples=5):
    """Stub the JAX experiments' model work: set_dtype, the models, L-BFGS
    and the sampler (its samples the model's unconstrained tree, each leaf
    n_samples of its value plus the draw's index)."""
    monkeypatch.setattr(JC, "set_dtype", lambda *a, **k: None)

    def get_model(model, data, cov, noise, device=None, stable=False):
        return _Stub(jax_unconstrain({"kernel": cov, "noise_variance": jnp.asarray(noise)}))

    def run_one_mcmc(model, priors, **kwargs):
        samples = {k: v for k, v in model.tree.items()}
        import jax

        return jax.tree.map(lambda x: np.asarray(x) + np.arange(n_samples), samples), 0.5, 0.1

    monkeypatch.setattr(JC, "get_model", get_model)
    monkeypatch.setattr(JC, "run_one_mcmc", run_one_mcmc)
    monkeypatch.setattr(jinference, "fit_lbfgs", lambda model, n_iters, priors: (model, np.arange(n_iters, dtype=float)))


def _names(path):
    with np.load(path) as data:
        return sorted(data.files)


def test_sunspot_map_writes_the_jax_clis_arrays(tmp_path, monkeypatch):
    """n = 60, three L-BFGS steps, a 2× prediction grid: the loss falls, the
    prediction is finite at 120 points, and the arrays are the JAX CLI's."""
    argv = ["--sizes", "60", "--maxiter", "3", "--pred-factor", "2"]
    _main(tmap, argv + ["--platform", "cpu", "--out-dir", str(tmp_path / "port")], monkeypatch)
    _stub_jax(monkeypatch)
    _main(jmap, argv + ["--out-dir", str(tmp_path / "jax")], monkeypatch)
    name = "sunspot_map_pssgp_n60.npz"
    assert _names(tmp_path / "port" / name) == _names(tmp_path / "jax" / name)
    with np.load(tmp_path / "port" / name) as out:
        assert out["mean"].shape == out["var"].shape == (120, 1) and np.isfinite(out["var"]).all()
        assert out["loss_history"].shape == (3,) and out["loss_history"][-1] < out["loss_history"][0]


def test_sunspot_mcmc_samples_cross_between_the_packages(tmp_path, monkeypatch):
    """n = 50, five HMC draws: the file's arrays are the JAX CLI's; the JAX
    package's load_samples reads the port's file into the JAX model's tree,
    leaf for leaf the port's samples; the port's load_samples reads it and
    a file the JAX CLI wrote."""
    from parallel_gps_tpu.experiments.sunspot.common import get_covariance_function, get_data

    argv = ["--sizes", "50", "--n-samples", "5", "--burnin", "2"]
    _main(tmcmc, argv + ["--platform", "cpu", "--out-dir", str(tmp_path / "port")], monkeypatch)
    name = "sunspot_mcmc_pssgp_hmc_n50.npz"
    t, y = get_data(50)
    jm = JaxStateSpaceGP.create((t, y), get_covariance_function(), noise_variance=300.0)
    jtree = JC.load_samples(str(tmp_path / "port" / name), jm)
    TC.set_dtype("float64", "cpu")
    tm = TC.get_model("pssgp", (t, y), TC.get_covariance_function("Matern32", 5500.0, 5.0), 300.0)
    ported = TC.load_samples(str(tmp_path / "port" / name), tm)
    assert list(ported) == ["kernel.raw_variance", "kernel.raw_lengthscales", "raw_noise_variance"]
    npt.assert_array_equal(np.asarray(jtree["kernel"].variance), ported["kernel.raw_variance"].numpy())
    npt.assert_array_equal(np.asarray(jtree["kernel"].lengthscales), ported["kernel.raw_lengthscales"].numpy())
    npt.assert_array_equal(np.asarray(jtree["noise_variance"]), ported["raw_noise_variance"].numpy())
    assert ported["raw_noise_variance"].shape == (5,)

    _stub_jax(monkeypatch)
    _main(jmcmc, argv + ["--out-dir", str(tmp_path / "jax")], monkeypatch)
    assert _names(tmp_path / "port" / name) == _names(tmp_path / "jax" / name)
    from_jax = TC.load_samples(str(tmp_path / "jax" / name), tm)
    u0 = {k: p.detach() for k, p in tm.named_parameters()}
    for k, v in from_jax.items():
        npt.assert_allclose(v.numpy(), float(u0[k]) + np.arange(5), rtol=1e-15, err_msg=k)


def test_toy_mcmc_writes_the_jax_clis_arrays(tmp_path, monkeypatch):
    """log2 size 6, five HMC draws: the arrays are the JAX CLI's (the size
    and the sample tree's leaf paths), the draws finite."""
    argv = ["--log2-sizes", "6", "--n-samples", "5", "--burnin", "2"]
    _main(ttoy_mcmc, argv + ["--platform", "cpu", "--out-dir", str(tmp_path / "port")], monkeypatch)
    _stub_jax(monkeypatch)
    _main(jtoy_mcmc, argv + ["--out-dir", str(tmp_path / "jax")], monkeypatch)
    name = "mcmc_pssgp_Matern32_hmc_float64.npz"
    assert _names(tmp_path / "port" / name) == _names(tmp_path / "jax" / name)
    with np.load(tmp_path / "port" / name) as out:
        assert out["n64_kernel_lengthscales"].shape == (5,) and np.isfinite(out["n64_noise_variance"]).all()


@pytest.mark.parametrize("model", ["pssgp", "gp"])
def test_toy_speed_writes_the_jax_clis_arrays(tmp_path, monkeypatch, model):
    """log2 sizes 6 and 7, two seeds: the arrays are the JAX CLI's, every
    time and RMSE finite, and the sunspot sweep is the same module."""
    argv = ["--log2-sizes", "6", "7", "--n-seeds", "2", "--model", model]
    _main(ttoy_speed, argv + ["--platform", "cpu", "--out-dir", str(tmp_path / "port")], monkeypatch)
    _stub_jax(monkeypatch)
    _main(jtoy_speed, argv + ["--out-dir", str(tmp_path / "jax")], monkeypatch)
    name = f"speed_stability_{model}_Matern32_float64.npz"
    assert _names(tmp_path / "port" / name) == _names(tmp_path / "jax" / name)
    with np.load(tmp_path / "port" / name) as out:
        assert out["rmses"].shape == (2, 2) and np.isfinite(out["rmses"]).all() and np.isfinite(out["times"]).all()
        assert out["rmses"].max() < 1.5
    assert tsun_speed.main is ttoy_speed.main


def test_plot_names_a12b_stable_names_a10_and_no_run_returns(tmp_path, monkeypatch):
    """``--plot`` raises naming A12b and ``--no-run`` writes nothing; since
    the square-root engine was ported (it raised naming A10 before),
    ``--stable`` runs the sweep on it, RMSEs within 1e-6 of the standard
    engine's in float64."""
    out = ["--platform", "cpu", "--out-dir", str(tmp_path / "none")]
    for module, argv in ((tmap, ["--sizes", "30"]), (tmcmc, ["--sizes", "30"]), (ttoy_speed, ["--log2-sizes", "5"])):
        with pytest.raises(NotImplementedError, match="A12b"):
            _main(module, argv + out + ["--plot"], monkeypatch)
        _main(module, argv + out + ["--no-run"], monkeypatch)
    assert not (tmp_path / "none").exists()
    rmses = {}
    for flags in ([], ["--stable"]):
        where = tmp_path / ("stable" if flags else "standard")
        _main(ttoy_speed, ["--platform", "cpu", "--log2-sizes", "5", "6", "--n-seeds", "1", "--out-dir", str(where)] + flags, monkeypatch)
        with np.load(where / "speed_stability_pssgp_Matern32_float64.npz") as f:
            rmses[bool(flags)] = f["rmses"]
    assert np.isfinite(rmses[True]).all()
    npt.assert_allclose(rmses[True], rmses[False], rtol=1e-6)
