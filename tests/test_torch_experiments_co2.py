"""The port's CO2 CLIs (parallel_gps_torch/experiments/co2) against the JAX
package's: the quasi-periodic covariance's LML, the priors and the
trainable set, the file and array names of a short run, ``--no-run`` and
``--plot``; f64 on the CPU."""
import sys

import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import config as tconfig
from parallel_gps_torch.experiments import common as TC
from parallel_gps_torch.experiments.co2 import common as tco2
from parallel_gps_torch.experiments.co2 import mcmc as tmcmc
from parallel_gps_torch.experiments.co2 import speed_and_stability as tspeed
from parallel_gps_torch.experiments.toy_models import speed_and_stability as ttoy_speed
from parallel_gps_torch.models.params import trainable_mask
from parallel_gps_tpu import config as jconfig
from parallel_gps_tpu.experiments import common as JC
from parallel_gps_tpu.experiments.co2 import common as jco2
from parallel_gps_tpu.experiments.co2 import mcmc as jmcmc
from parallel_gps_tpu.kalman.sequential import kf
from parallel_gps_tpu.models.params import unconstrain as jax_unconstrain
from _torch_common import jit_o0

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_defaults():
    """The CLIs set torch's default float and the models' device for the
    process: put both back for the tests that follow."""
    dtype, device = torch.get_default_dtype(), TC._DEVICE[0]
    TC.set_dtype("float64", "cpu")
    yield
    torch.set_default_dtype(dtype)
    TC._DEVICE[0] = device


def _main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    module.main()


def test_covariance_lml_matches_jax():
    """Periodic(order 3) × Matern32 + Matern32, d = 18, on the last 150
    observations: the port's model (the plain time-last engine) against the
    JAX covariance's model under the JAX sequential filter.  Both packages
    balance with one sweep here (``set_number_balancing_steps``): the
    traced loop of ten is most of the reference's compile."""
    t, y = tco2.get_data(150)
    y = y - y.mean()
    steps = (tconfig.NUMBER_OF_BALANCING_STEPS, jconfig.NUMBER_OF_BALANCING_STEPS)
    try:
        tconfig.set_number_balancing_steps(1)
        jconfig.set_number_balancing_steps(1)
        cov = tco2.get_covariance_function(3)
        assert cov.state_dim == 18
        model = TC.get_model("pssgp", (t, y), cov, 0.05)
        assert model.engine() == ("timelast", None)
        lml = float(model.log_marginal_likelihood().detach())
        jcov = jco2.get_covariance_function(3)
        jl = jit_o0(lambda s, o: kf(jcov.get_ssm(s, jnp.asarray([[0.05]])), o, return_loglikelihood=True)[2])(jnp.asarray(t), jnp.asarray(y))
    finally:
        tconfig.set_number_balancing_steps(steps[0])
        jconfig.set_number_balancing_steps(steps[1])
    npt.assert_allclose(lml, float(jl), rtol=1e-10)


def test_priors_and_trainable_match_jax():
    """Each prior's log-density at the covariance's values, and the
    trainable set: the JAX paths (kernels.i…) are the port's names under
    ``kernel.``."""
    jpriors, tpriors = jco2.get_priors(), tco2.get_priors()
    assert sorted(tpriors) == sorted("kernel." + k for k in jpriors)
    values = {"kernels.0.kernels.0.lengthscales": 1.0, "kernels.0.kernels.1.variance": 0.1,
              "kernels.0.kernels.1.lengthscales": 50.0, "kernels.1.variance": 1.0, "kernels.1.lengthscales": 100.0}
    for path, (jlogpdf, on) in jpriors.items():
        tlogpdf, ton = tpriors["kernel." + path]
        assert on == ton == "constrained"
        npt.assert_allclose(float(tlogpdf(torch.tensor(values[path]))), float(jlogpdf(values[path])), rtol=1e-14)
    model = TC.get_model("pssgp", tco2.get_data(40), tco2.get_covariance_function(3), 0.05)
    fixed = sorted(n for n, keep in trainable_mask(model, tco2.trainable).items() if not keep)
    assert fixed == ["kernel.kernels.0.kernels.0.raw_period", "kernel.kernels.0.kernels.0.raw_variance", "raw_noise_variance"]
    for name in trainable_mask(model, tco2.trainable):
        dotted = name.replace("raw_", "")
        assert tco2.trainable(dotted) == jco2.trainable(dotted.removeprefix("kernel."))


def test_short_run_writes_the_jax_clis_arrays(tmp_path, monkeypatch):
    """n = 60, two HMC draws: the file and its arrays are the JAX CLI's
    (its model work stubbed out), the draws finite; ``--no-run`` writes
    nothing and ``--plot`` names A12b; the sweep is the toy-model one."""
    argv = ["--n-training", "60", "--n-samples", "2", "--burnin", "1"]
    _main(tmcmc, argv + ["--platform", "cpu", "--out-dir", str(tmp_path / "port")], monkeypatch)

    def get_model(model, data, cov, noise, device=None, stable=False):
        return type("Stub", (), {"tree": jax_unconstrain({"kernel": cov, "noise_variance": jnp.asarray(noise)})})()

    def run_one_mcmc(model, priors, **kwargs):
        import jax

        return jax.tree.map(lambda x: np.asarray(x) + np.arange(2), model.tree), 0.5, 0.1

    monkeypatch.setattr(JC, "set_dtype", lambda *a, **k: None)
    monkeypatch.setattr(JC, "get_model", get_model)
    monkeypatch.setattr(JC, "run_one_mcmc", run_one_mcmc)
    _main(jmcmc, argv + ["--out-dir", str(tmp_path / "jax")], monkeypatch)
    name = "co2_mcmc_pssgp_hmc.npz"
    with np.load(tmp_path / "port" / name) as port, np.load(tmp_path / "jax" / name) as jax_out:
        assert sorted(port.files) == sorted(jax_out.files)
        draws = [port[f"sample_{j}"] for j in range(8)]
        assert all(x.shape == (2,) and np.isfinite(x).all() for x in draws)
        assert np.isfinite(port["accepts"]).all() and port["y_mean"] > 300.0
    empty = tmp_path / "none"
    _main(tmcmc, argv + ["--platform", "cpu", "--out-dir", str(empty), "--no-run"], monkeypatch)
    assert not empty.exists()
    with pytest.raises(NotImplementedError, match="A12b"):
        _main(tmcmc, argv + ["--platform", "cpu", "--out-dir", str(empty), "--plot"], monkeypatch)
    assert tspeed.main is ttoy_speed.main
