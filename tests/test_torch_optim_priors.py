"""PyTorch port vs the JAX package: trainability masks, priors
(models/params.py) and the MAP objective; f64 on the CPU."""
import jax.numpy as jnp
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch.inference import fit_adam, make_log_posterior, make_loss
from parallel_gps_torch.models.params import log_prior, trainable_mask
from parallel_gps_tpu.models.params import log_prior as jax_log_prior
from _torch_optim import _data, _model, _raw

torch.set_num_threads(1)


def test_trainable_mask_names_the_constrained_quantities():
    t, y = _data(10, 0)
    tm = _model("Matern32", t, y, 1.0, 0.5, 0.1)
    mask = trainable_mask(tm, lambda name: name.endswith("variance"))
    assert mask == {"raw_noise_variance": True, "kernel.raw_variance": True, "kernel.raw_lengthscales": False}


@pytest.mark.parametrize("on", ["unconstrained", "constrained"])
def test_log_prior_matches_jax(on):
    """Both prior kinds on the same unconstrained values, rtol 1e-12; the
    longest matching suffix wins."""
    t, y = _data(10, 0)
    tm = _model("Matern52", t, y, 0.7, 1.9, 0.25)
    u = dict(zip(("variance", "lengthscales", "noise"), _raw(tm)))
    tree = {"kernel": {"variance": jnp.asarray(u["variance"]), "lengthscales": jnp.asarray(u["lengthscales"])},
            "noise_variance": jnp.asarray(u["noise"])}

    def spec(logpdf):
        return logpdf if on == "unconstrained" else (logpdf, "constrained")

    priors = {
        "variance": spec(lambda x: -0.5 * (x - 0.3) ** 2),  # noise_variance and, but for the longer one, kernel.variance
        "kernel.variance": spec(lambda x: -2.0 * x * x),
        "lengthscales": spec(lambda x: -1.5 * x),
    }
    got = log_prior(tm, priors)
    npt.assert_allclose(float(got.detach()), float(jax_log_prior(tree, priors)), rtol=1e-12)
    assert got.requires_grad
    assert log_prior(tm, {"period": lambda x: x}) == 0.0


def test_log_posterior_and_map_objective():
    """``make_log_posterior`` = LML + log prior with frozen leaves pinned to
    their initial values, and ``fit_adam(priors=...)`` starts from its
    negative."""
    t, y = _data(60, 4)
    tm = _model("Matern32", t, y, 1.0, 0.5, 0.2)
    priors = {"kernel.lengthscales": (lambda x: -3.0 * x, "constrained"), "noise_variance": lambda u: -0.5 * u * u}
    loss, u0 = make_loss(tm)
    assert set(u0) == {name for name, _ in tm.named_parameters()}
    with torch.no_grad():
        lml = float(tm.log_marginal_likelihood())
        npt.assert_allclose(float(loss(u0)), -lml, rtol=1e-14)
        log_post, u0 = make_log_posterior(tm, priors)
        npt.assert_allclose(float(log_post(u0)), lml + float(log_prior(tm, priors)), rtol=1e-14)
        pinned, _ = make_log_posterior(tm, priors, trainable=lambda name: name != "noise_variance")
        moved = {**u0, "raw_noise_variance": u0["raw_noise_variance"] + 1.0}
        assert float(pinned(moved)) == float(log_post(u0))
        assert float(log_post(moved)) != float(log_post(u0))
    _, history = fit_adam(tm, n_iters=1, priors=priors)
    npt.assert_allclose(float(history[0]), -float(log_post(u0).detach()), rtol=1e-12)
