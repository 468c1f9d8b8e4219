"""PyTorch port vs the JAX package: the native balancing routine
(ops/native.py, native/balance.c compiled at first use) against the port's
vectorised numpy loop, against the JAX package's host routine and its numpy
fallback; its build under racing processes."""
import concurrent.futures
import subprocess
import sys

import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch.kernels import RBF
from parallel_gps_torch.ops import native
from parallel_gps_torch.ops.balance import balance_scale
from parallel_gps_tpu.ops import native as jnative

torch.set_num_threads(1)


def _matrices(d, n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(d, d) * np.logspace(-3, 3, d)[:, None] for _ in range(n)]


@pytest.mark.parametrize("d", [2, 3, 6, 8])
def test_c_routine_is_the_vectorised_loop_bit_for_bit(d):
    """Up to d = 8 the compiled routine sums in the order of the port's
    numpy loop (the batched route of ops/balance.py), without contraction:
    the same bits.  RBF's companion F included."""
    assert native.load() is not None, "the C compiler is needed here"
    Fs = _matrices(d, 20, d) + [RBF(1.0, 0.3, order=d, dtype=torch.float64, device="cpu")._scaled_F().detach().numpy()]
    for F in Fs:
        single = balance_scale(torch.tensor(F), 10).numpy()  # one matrix: the C routine
        batched = balance_scale(torch.tensor(F[None]), 10)[0].numpy()  # a batch: the numpy loop
        npt.assert_array_equal(single, batched)
        npt.assert_array_equal(single, native.balance_scale_host(F, 10))


@pytest.mark.parametrize("d", [5, 12])
def test_matches_the_jax_host_routine_and_fallbacks(d):
    """Against the JAX package's C routine and its numpy fallback, and the
    port's own fallback against the JAX one; above d = 8 the vectorised
    loop's eight-lane sums differ from the C routine in the last bits."""
    for F in _matrices(d, 10, 100 + d):
        got = native.balance_scale_host(F, 10)
        npt.assert_allclose(got, jnative.balance_scale_host(F, 10), rtol=1e-13)
        npt.assert_allclose(native._np_balance_scale(F, 10), jnative._np_balance_scale(F, 10), rtol=0, atol=0)
        npt.assert_allclose(got, native._np_balance_scale(F, 10), rtol=1e-12)
        npt.assert_allclose(got, balance_scale(torch.tensor(F[None]), 10)[0].numpy(), rtol=1e-12)


def test_degenerate_rows_and_refusals():
    """A zero row or column leaves its scale at 1 (no NaN); a batch is the
    numpy loop's, not this routine's."""
    F = np.zeros((3, 3))
    F[0, 1] = 2.0
    got = native.balance_scale_host(F, 5)
    npt.assert_array_equal(got, jnative.balance_scale_host(F, 5))
    assert np.isfinite(got).all()
    with pytest.raises(ValueError, match="square"):
        native.balance_scale_host(np.zeros((2, 3, 3)), 5)


def test_build_races_and_falls_back(tmp_path, monkeypatch):
    """Processes that build the library at once each load a whole one (the
    compile writes a temporary name and renames it); without a compiler
    ``balance_scale_host`` runs its numpy loop and the port's single-matrix
    balancing the vectorised loop, the C routine's bits."""
    # The module alone (stdlib and numpy), not the package (which imports torch).
    code = (
        "import importlib.util as u, numpy as np; from pathlib import Path; "
        f"spec = u.spec_from_file_location('native', {native.__file__!r}); native = u.module_from_spec(spec); "
        "spec.loader.exec_module(native); "
        f"native.BUILD_DIR = Path({str(tmp_path)!r}); "
        "lib = native.load(); assert lib is not None; "
        "F = np.arange(16.0).reshape(4, 4) + 1.0; print(native.balance_scale_host(F, 5).tolist())"
    )
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        runs = list(pool.map(lambda _: subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120), range(3)))
    assert all(r.returncode == 0 for r in runs), [r.stderr for r in runs]
    assert len({r.stdout for r in runs}) == 1
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native, "_LIB", [])
    monkeypatch.setenv("PATH", str(tmp_path / "no_compiler"))
    F = np.arange(16.0).reshape(4, 4) + 1.0
    assert native.load() is None
    npt.assert_array_equal(native.balance_scale_host(F, 5), native._np_balance_scale(F, 5))
    npt.assert_array_equal(balance_scale(torch.tensor(F), 5).numpy(), balance_scale(torch.tensor(F[None]), 5)[0].numpy())
