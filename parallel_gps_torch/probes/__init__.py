"""Probe programs: what the port's kernels' access patterns and launches
cost on the card (counterparts of the JAX package's probe scripts
``scripts/bench_dma_probe.py``, ``bench_r4_attrib.py`` and
``bench_grid_isolation.py``, which they do not import).

  - ``python -m parallel_gps_torch.probes.dma``: an (n, T) copy in the
    two-pass kernels' chunk pattern, coalesced and in blocked tiles;
  - ``python -m parallel_gps_torch.probes.attrib``: the read floor of a
    strip-filter pass beside the passes and entry points themselves, and the
    cost of one launch;
  - ``python -m parallel_gps_torch.probes.grid``: the cost of a block against
    its tile length, and of a carry across tiles.

Their kernels are ``csrc/probes.cu``; each has a plain PyTorch version
beside its wrapper, which the wrapper takes for CPU tensors.  They run on the
card by default, raise without one, and with ``--device cpu --T <small>``
run the plain versions and time nothing.  ``common.LAUNCHES`` counts the
probe kernels' launches.
"""
