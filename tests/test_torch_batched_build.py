"""PyTorch port: the batch axis of the SDE build and of the Lyapunov solve
against loops of scalar builds, the per-chain log prior, the position trees,
and what the batched path does not cover.  f64 on the CPU.
"""
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch import kernels as tk
from parallel_gps_torch.models.params import log_prior, positions_from_tree, positions_to_tree
from parallel_gps_torch.ops.balance import balance_scale
from parallel_gps_torch.ops.lyapunov import solve_lyap_vec
from _torch_batched import C_CHAINS, ELL, MATERN, NOISE, PRIORS, VAR, _data, _t

torch.set_num_threads(1)


@pytest.mark.parametrize("name,d", MATERN, ids=["m12", "m32", "m52"])
def test_batched_sde_build_equals_a_loop_of_scalar_builds(name, d):
    """``get_sde``, ``transition_coeffs`` and ``balance_scale`` on
    hyperparameters of shape (C,): bit-equal to C scalar builds."""
    kb = getattr(tk, name)(VAR, ELL, dtype=torch.float64, device="cpu")
    with torch.no_grad():
        sde_b = kb.get_sde()
        fam_b, co_b = kb.transition_coeffs()
        assert sde_b.P0.shape == (C_CHAINS, d, d) and sde_b.F.shape == (C_CHAINS, d, d) and co_b.shape[0] == C_CHAINS
        for c in range(C_CHAINS):
            ks = getattr(tk, name)(VAR[c], ELL[c], dtype=torch.float64, device="cpu")
            sde = ks.get_sde()
            fam, co = ks.transition_coeffs()
            assert fam == fam_b and torch.equal(co, co_b[c])
            for leaf_b, leaf in zip(sde_b, sde):
                assert torch.equal(leaf_b[c] if leaf_b.dim() == leaf.dim() + 1 else leaf_b, leaf)
            assert torch.equal(balance_scale(sde_b.F, 7)[c], balance_scale(sde.F, 7))


def test_scalar_and_batched_hyperparameters_broadcast():
    """A kernel with one batched and one scalar hyperparameter builds the
    batch (a sampler with some leaves pinned)."""
    k = tk.Matern52(VAR, 0.4, dtype=torch.float64, device="cpu")
    ref = tk.Matern52(VAR, np.full(C_CHAINS, 0.4), dtype=torch.float64, device="cpu")
    with torch.no_grad():
        assert torch.equal(k.get_sde().P0, ref.get_sde().P0)
        assert torch.equal(k.transition_coeffs()[1], ref.transition_coeffs()[1])


def test_singular_lyapunov_system_raises_alone_and_is_non_finite_in_a_batch():
    """One singular system is an error, as before the batch axis; in a batch
    it makes its own chain non-finite and leaves the others their values."""
    F = _t([[0.0, 1.0], [-3.0, -2.0]])
    L, Q = _t([[0.0], [1.0]]), _t([[2.0]])
    good = solve_lyap_vec(F, L, Q)
    npt.assert_allclose((F @ good + good @ F.T + L @ Q @ L.T).numpy(), 0.0, atol=1e-14)
    singular = torch.zeros_like(F)
    with pytest.raises(torch.linalg.LinAlgError):
        solve_lyap_vec(singular, L, Q)
    both = solve_lyap_vec(torch.stack([F, singular, F]), L, Q)
    assert torch.equal(both[0], good) and torch.equal(both[2], good)
    assert not bool(torch.isfinite(both[1]).all())


def test_log_prior_is_summed_per_chain():
    t, y = _data(10, 0)
    mb = StateSpaceGP.from_numpy(t, y, "Matern32", VAR, ELL, NOISE, dtype=torch.float64, device="cpu")
    per_chain = log_prior(mb, PRIORS, batch_ndim=1)
    assert per_chain.shape == (C_CHAINS,)
    for c in range(C_CHAINS):
        ms = StateSpaceGP.from_numpy(t, y, "Matern32", VAR[c], ELL[c], NOISE[c], dtype=torch.float64, device="cpu")
        npt.assert_allclose(float(per_chain[c].detach()), float(log_prior(ms, PRIORS).detach()), rtol=1e-12)
    npt.assert_allclose(float(log_prior(mb, PRIORS).detach()), float(per_chain.sum().detach()), rtol=1e-12)  # the default sums over every axis


def test_position_trees_round_trip():
    t, y = _data(10, 0)
    tm = StateSpaceGP.from_numpy(t, y, "Matern52", 1.0, 1.0, 1.0, dtype=torch.float64, device="cpu")
    tree = {"kernel": {"variance": np.arange(3.0), "lengthscales": np.arange(3.0) + 5}, "noise_variance": -np.arange(3.0)}
    pos = positions_from_tree(tree, tm)
    assert set(pos) == {"kernel.raw_variance", "kernel.raw_lengthscales", "raw_noise_variance"}
    assert list(pos) == [n for n, _ in tm.named_parameters()]
    back = positions_to_tree(pos)
    npt.assert_array_equal(back["kernel"]["lengthscales"], tree["kernel"]["lengthscales"])
    npt.assert_array_equal(back["noise_variance"], tree["noise_variance"])


def test_what_the_batched_path_does_not_cover_raises():
    """RBF chains and a batched Matérn ``predict_f`` are covered now: their
    LML, SDE and predictions equal those of C scalar models.  Chains on the
    sequential engine (``parallel=False``) still raise and name the ROADMAP
    item that holds them."""
    t, y = _data(20, 0)
    X = np.array([0.5, -0.2, 0.1])
    rbf = StateSpaceGP.from_numpy(t, y, "RBF", VAR, ELL, NOISE, dtype=torch.float64, device="cpu", order=4)
    lml = rbf.log_marginal_likelihood().detach()
    with torch.no_grad():
        sde = rbf.kernel.get_sde()
    assert lml.shape == (C_CHAINS,) and sde.P0.shape == (C_CHAINS, 4, 4)
    mb = StateSpaceGP.from_numpy(t, y, "Matern32", VAR, ELL, NOISE, dtype=torch.float64, device="cpu")
    mean, var = mb.predict_f(X)
    assert mean.shape == var.shape == (C_CHAINS, X.size, 1)
    for c in range(C_CHAINS):
        one = StateSpaceGP.from_numpy(t, y, "RBF", VAR[c], ELL[c], NOISE[c], dtype=torch.float64, device="cpu", order=4)
        npt.assert_allclose(float(lml[c]), float(one.log_marginal_likelihood().detach()), rtol=1e-9)
        with torch.no_grad():
            npt.assert_allclose(sde.P0[c].numpy(), one.kernel.get_sde().P0.numpy(), rtol=1e-12, atol=1e-14)
        m_c, v_c = StateSpaceGP.from_numpy(t, y, "Matern32", VAR[c], ELL[c], NOISE[c], dtype=torch.float64, device="cpu").predict_f(X)
        npt.assert_allclose(mean[c].numpy(), m_c.numpy(), rtol=1e-9, atol=1e-12)
        npt.assert_allclose(var[c].numpy(), v_c.numpy(), rtol=1e-9, atol=1e-12)
    seq = StateSpaceGP.from_numpy(t, y, "Matern32", VAR, ELL, NOISE, dtype=torch.float64, device="cpu", parallel=False)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        seq.log_marginal_likelihood()
