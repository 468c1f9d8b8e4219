"""The port's probe programs (parallel_gps_torch/probes/, kernels in
csrc/probes.cu) on the CPU: each plain version against a numpy restatement of
the Pallas body it replaces in the JAX package's probe scripts (the bodies are
closures inside the scripts' ``main()`` and cannot be imported), the command
lines' records, and the dispatch contract of the kernel wrappers.  f64,
T of a few thousand."""
import json
import math
import re
from pathlib import Path

import numpy as np
import numpy.testing as npt
import pytest
import torch

from parallel_gps_torch.kalman import _cuda
from parallel_gps_torch.probes import attrib, common, dma, grid

torch.set_num_threads(1)

T = 4099  # a multiple of no tile or chunk
ROOT = Path(__file__).resolve().parent.parent


def _rows(n, T_, seed):
    return np.random.RandomState(seed).rand(n, T_)


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("layout", ["rows", "blocked"])
def test_copies_are_the_copy_kernel(layout):
    """bench_dma_probe.py:56-57, ``o_ref[:] = x_ref[:]``: every copy gives its
    input back, on (n, T) rows and on the (n_tiles, n, tile) blocked layout."""
    x = _rows(27, T, 0) if layout == "rows" else _rows(5 * 12, 1024, 1).reshape(5, 12, 1024)
    ref = x.copy()
    fns = [dma.copy_plain, dma.copy_coalesced]
    fns += [lambda s, K=K: dma.copy_chunk(s, K) for K in dma.CHUNKS] if layout == "rows" else [dma.copy_blocked]
    for fn in fns:
        npt.assert_array_equal(fn(_t(x)).numpy(), ref)


@pytest.mark.parametrize("coalesced", [False, True], ids=["chunk", "coalesced"])
@pytest.mark.parametrize("d,K", [(3, 64), (2, 8)])
def test_read_plain_is_the_read_kernel(coalesced, d, K):
    """bench_r4_attrib.py:98-108 on the strip filter's staged inputs
    (pallas_scan.py:950-953: y with NaN as 0, a mask of the observed steps):
    ``sum(F) + sum(Q) + y + mask`` over each block's steps — here each block
    of 128·K steps; the plain read sums in another order, rtol 1e-12."""
    rng = np.random.RandomState(d + K)
    Fs, Qs = rng.randn(d, d, T), rng.rand(d, d, T)
    y = rng.randn(T)
    y[rng.rand(T) < 0.1] = np.nan
    mask = ~np.isnan(y)
    s = Fs.reshape(d * d, T).sum(0) + Qs.reshape(d * d, T).sum(0) + np.where(mask, y, 0.0) + mask
    tile = 128 * K
    ref = np.array([s[i : i + tile].sum() for i in range(0, T, tile)])
    got = attrib.read_plain(_t(Fs), _t(Qs), _t(y), K, coalesced)
    npt.assert_allclose(got.numpy(), ref, rtol=1e-12)
    assert torch.equal(attrib.read(_t(Fs), _t(Qs), _t(y), K, coalesced), got)


@pytest.mark.parametrize("kernel", ["noop", "stream3", "stream22", "outwrite12", "carry33"])
@pytest.mark.parametrize("tile", [256, 1024])
def test_tile_plain_versions_are_the_grid_kernels(kernel, tile):
    """bench_grid_isolation.py: k_noop (:102) writes ones; k_stream (:105)
    sums the tile's rows (there only its first 128 lanes; here every value);
    k_outwrite (:123) writes row 0 to 12 rows; k_carry (:109) adds k to carry
    value k at every grid step, so it ends at k · n_tiles — here each tile
    also writes its sum plus carry value 32.  Sums to rtol 1e-12."""
    n = math.ceil(T / tile)
    x = _rows(22, T, 5)
    sums = lambda rows: np.array([rows[:, i : i + tile].sum() for i in range(0, T, tile)])  # noqa: E731
    if kernel == "noop":
        out = grid.tile_noop(torch.zeros(n, dtype=torch.float64))
        npt.assert_array_equal(out.numpy(), np.ones(n))
    elif kernel.startswith("stream"):
        r = int(kernel[len("stream"):])
        npt.assert_allclose(grid.tile_stream(_t(x[:r]), tile).numpy(), sums(x[:r]), rtol=1e-12)
    elif kernel == "outwrite12":
        rows12, parts = grid.tile_outwrite(_t(x[:3]), tile)
        npt.assert_array_equal(rows12.numpy(), np.repeat(x[:1], 12, axis=0))
        npt.assert_allclose(parts.numpy(), sums(x[:3]), rtol=1e-12)
    else:
        carry = np.zeros(33)
        outs = []
        for b in range(n):
            carry = carry + np.arange(33)
            outs.append(x[0, b * tile : (b + 1) * tile].sum() + carry[32])
        out, c = grid.tile_carry(_t(x[0]), tile)
        npt.assert_array_equal(c.numpy(), carry)
        npt.assert_array_equal(c.numpy(), np.arange(33) * n)
        npt.assert_allclose(out.numpy(), outs, rtol=1e-12)


def test_stream_plain_sums_in_the_kernel_order():
    """The tile sums' order — thread j takes steps j, j + 256, ..., each
    step's rows in order, then the block's tree — restated in numpy float32
    gives the plain float32 version's bits, a ragged last tile included."""
    x = _rows(3, 1000, 9).astype(np.float32)
    tile = 512
    ref = []
    for b in range(math.ceil(1000 / tile)):
        acc = np.zeros(256, np.float32)
        for i in range(tile // 256):
            for j in range(256):
                t = b * tile + i * 256 + j
                if t < 1000:
                    for r in range(3):
                        acc[j] = np.float32(acc[j] + x[r, t])
        n = 256
        while n > 1:
            n //= 2
            acc[:n] = acc[:n] + acc[n : 2 * n]
        ref.append(acc[0])
    assert np.array_equal(grid.stream_plain(torch.tensor(x), tile).numpy(), np.array(ref, np.float32))


PROBES = {"dma": dma, "attrib": attrib, "grid": grid}
BENCHES = {
    "dma": {"copy_chunk", "copy_coalesced", "copy_blocked"},
    "attrib": {"setup", "read_chunk", "read_coalesced", "strip_filter_scan", "strip_filter_apply", "strip_filter",
               "lml_tl_strip", "pkfs_from_tl_strip", "launch"},
    "grid": {"noop", "stream3", "stream22", "outwrite12", "carry33", "slope"},
}


@pytest.mark.parametrize("name", PROBES)
def test_cli_on_the_cpu_emits_its_records(name, tmp_path, capsys):
    """``main(["--device", "cpu", ...])`` runs the plain versions at a small
    T, prints one JSON line a record and writes them all to ``--out``; times
    are not measured off the card, and kernel and plain version agree."""
    out = tmp_path / f"{name}.json"
    recs = PROBES[name].main(["--device", "cpu", "--T", "2051", "--dtype", "float64", "--reps", "1", "--out", str(out)])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert lines == recs == json.loads(out.read_text())
    assert {r["bench"] for r in recs} == BENCHES[name]
    for r in recs:
        assert r["probe"] == name and r["device"] == "cpu" and r["card"] is None and r["dtype"] == "float64"
        assert r.get("ms") is None and r.get("us_per_tile") is None and r.get("device_us") is None
        assert r.get("max_abs_err", 0.0) == 0.0
        if "bytes" in r and r["bytes"] is not None:
            assert r["bound_ms"] == pytest.approx(1e3 * r["bytes"] / common.PEAK_BYTES_PER_S)
    if name == "dma":
        assert {(r["rows"], r.get("K"), r.get("tile")) for r in recs} >= {(27, 64, None), (12, 64, None), (12, None, 2048)}
    if name == "grid":
        assert {r["tile"] for r in recs if "tile" in r} == set(grid.TILES)
    assert set(common.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("name", PROBES)
def test_default_device_is_the_card_and_raises_without_one(name, monkeypatch, tmp_path):
    """``--device`` defaults to cuda: without a card the probe raises and
    writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PROBES[name].main(["--T", "300", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_wrappers_refuse_non_cuda_tensors_instead_of_falling_back():
    """A tensor off the CPU goes to the kernel wrapper, which refuses what it
    cannot launch; no launch is counted."""
    meta = torch.zeros(3, 300, device="meta", dtype=torch.float64)
    planes = torch.zeros(3, 3, 300, device="meta", dtype=torch.float64)
    calls = [
        lambda: dma.copy_chunk(meta), lambda: dma.copy_coalesced(meta), lambda: dma.copy_blocked(meta.reshape(3, 3, 100)),
        lambda: attrib.read(planes, planes, meta[0]), lambda: attrib.read(planes, planes, meta[0], coalesced=True),
        lambda: grid.tile_noop(meta[0]), lambda: grid.tile_stream(meta, 256),
        lambda: grid.tile_outwrite(meta, 256), lambda: grid.tile_carry(meta[0], 256),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    assert set(common.LAUNCHES.values()) == {0}


def test_python_side_agrees_with_the_cuda_source():
    """Every counted kernel has its ``pgt_probe_<entry>`` entry in
    csrc/probes.cu (both read patterns share ``pgt_probe_read``) and a ctypes
    signature in the loader, and the threads per block the plain versions
    assume are the source's."""
    src = (ROOT / "parallel_gps_torch" / "csrc" / "probes.cu").read_text()
    loader = (ROOT / "parallel_gps_torch" / "kalman" / "_cuda.py").read_text()
    for name in common.LAUNCHES:
        entry = "read" if name.startswith("read_") else name
        assert re.search(rf"\bint pgt_probe_{entry}\(", src), name
        assert f'"pgt_probe_{entry}"' in loader, name
    assert re.search(rf"kChunkThreads = {common.CHUNK_THREADS};", src) and common.CHUNK_THREADS == _cuda.THREADS
    assert re.search(rf"kTileThreads = {common.TILE_THREADS};", src)
