"""The port's copy and read-floor probes (parallel_gps_torch/probes/, kernels
in csrc/probes.cu) on the CPU: each plain version against a numpy
restatement of the Pallas body it replaces in the JAX package's probe
scripts (the bodies are closures inside the scripts' ``main()`` and cannot
be imported), the tile sums' order, the wrappers' refusals, and the Python
side against the CUDA source.  f64, T of a few thousand."""
import math
import re

import numpy as np
import numpy.testing as npt
import pytest
import torch

from pathlib import Path
from parallel_gps_torch.kalman import _cuda
from parallel_gps_torch.probes import attrib, common, dma, grid
from _torch_probes import T, _rows, _t

torch.set_num_threads(1)


ROOT = Path(__file__).resolve().parent.parent


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
