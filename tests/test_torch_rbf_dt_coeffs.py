"""PyTorch port vs the JAX package: RBF's spectral transition family for the
dt engine — ``transition_coeffs()``, the plain build
``spectral_transitions_m1``, the kernels' padded layout, the engine choice
and the dt kernels' family checks; f64 on the CPU."""
import jax.numpy as jnp
import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch import StateSpaceGP
from parallel_gps_torch.kalman import dt as tdt
from parallel_gps_torch.kernels.matern import EXPPOLY, build_transitions_m1
from parallel_gps_torch.kernels.rbf import SPECTRAL, spectral_blocks
from _torch_rbf_dt import _data, _kernels

torch.set_num_threads(1)

# The coefficient counts of the spectral layout at orders 1..8 (1 + d³).
N_COEFFS = {1: 2, 2: 9, 3: 28, 4: 65, 5: 126, 6: 217, 7: 344, 8: 513}


@pytest.mark.parametrize("order", range(1, 9))
def test_transition_coeffs_and_build_match_jax(order):
    """``transition_coeffs()`` equals the JAX kernel's to 1e-12 (f64), and
    the plain build from them, ``build_transitions_m1(SPECTRAL, …)``, equals
    both JAX ``transitions_m1_tl`` and the JAX ``build`` closure applied to
    the same coefficients (tiny, zero and large gaps)."""
    jkern, tkern = _kernels(order)
    j_coeffs, j_build = jkern.transition_coeffs()
    family, coeffs = tkern.transition_coeffs()
    assert family == SPECTRAL and coeffs.shape == (N_COEFFS[order],)
    npt.assert_allclose(coeffs.detach().numpy(), np.asarray(j_coeffs), rtol=1e-12, atol=1e-12 * np.abs(j_coeffs).max())
    dts = np.concatenate([[0.0, 1e-9, 1e-5], np.random.RandomState(order).rand(20) * 0.2, [1.5]])
    Am1 = build_transitions_m1(family, coeffs.detach(), torch.tensor(dts), order).numpy()
    ref = np.asarray(jkern.transitions_m1_tl(jnp.asarray(dts)))
    npt.assert_allclose(Am1, ref, rtol=1e-9, atol=1e-12 * np.abs(ref).max())
    rows = j_build(j_coeffs, jnp.asarray(dts))
    closure = np.stack([np.stack([np.asarray(x) for x in row]) for row in rows])
    npt.assert_allclose(Am1, closure, rtol=1e-9, atol=1e-12 * np.abs(closure).max())
    assert not Am1[:, :, 0].any(), "dt = 0 must give Am1 = 0 exactly"


def test_engine_choice_layout_and_refusals():
    """RBF of every order ≤ 8 with ``parallel=True`` takes the dt engine, the
    Matérn kernels keep it, and a batch of RBF hyperparameters takes it too,
    each chain's coefficients and kernel layout the scalar kernel's; the
    kernels' layout holds every coefficient at its
    position, a real root's S as zeros, and the block table after; the
    family checks state each family's own limits."""
    t, y = _data(40, 0)
    opts = dict(dtype=torch.float64, device="cpu")
    for order in range(1, 9):
        m = StateSpaceGP.from_numpy(t, y, "RBF", 1.0, 0.3, 0.1, order=order, **opts)
        engine, (family, coeffs) = m.engine()
        assert (engine, family) == ("dt", SPECTRAL)
        kc = tdt.kernel_coeffs(family, coeffs.detach(), order)
        blocks = spectral_blocks(order)
        assert len(blocks) == (order + 1) // 2 and sum(1 + (b != 0.0) for _, b in blocks) == order
        n = 1 + 2 * len(blocks) * order * order
        pos = tdt._spectral_positions(order)
        assert kc.shape == (n + 2 * len(blocks),) and torch.equal(kc[pos], coeffs.detach())
        rest = torch.ones(n, dtype=torch.bool)
        rest[pos] = False
        assert not kc[:n][rest].any()
        npt.assert_array_equal(kc[n:].numpy(), np.ravel(blocks))
    for name in ("Matern12", "Matern32", "Matern52"):
        assert StateSpaceGP.from_numpy(t, y, name, 1.0, 0.3, 0.1, **opts).engine()[0] == "dt"
    chains = StateSpaceGP.from_numpy(t, y, "RBF", np.full(3, 1.0), np.full(3, 0.3), 0.1, order=4, **opts)
    engine, (family, coeffs) = chains.engine()
    single = StateSpaceGP.from_numpy(t, y, "RBF", 1.0, 0.3, 0.1, order=4, **opts).engine()[1][1].detach()
    assert (engine, family) == ("dt", SPECTRAL) and coeffs.shape == (3, 1 + 4**3)
    kc = tdt.kernel_coeffs(family, coeffs.detach(), 4)
    for c in range(3):
        assert torch.equal(coeffs[c].detach(), single)
        assert torch.equal(kc[c], tdt.kernel_coeffs(family, single, 4))
    with pytest.raises(ValueError, match=r"outside 1\.\.8"):
        tdt._check_family(SPECTRAL, 9, 1 + 9**3)
    with pytest.raises(ValueError, match=r"outside 1\.\.3"):
        tdt._check_family(EXPPOLY, 4, 1 + 3 * 16)
    with pytest.raises(ValueError, match="spectral layout"):
        tdt._check_family(SPECTRAL, 6, 216)
    assert tdt._check_family(SPECTRAL, 8, 513) == 0 and tdt._check_family(EXPPOLY, 3, 19) == 2
