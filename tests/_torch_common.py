"""Helpers that the port's test files share."""
import contextlib

import jax
import numpy as np
import torch


@contextlib.contextmanager
def _no_compile_cache():
    """Interpret-mode programs segfault in the persistent compilation cache
    (see test_model_interpret.py); disable it around them, and only there:
    the jitted references keep the cache."""
    from jax._src import compilation_cache as _cc

    jax.config.update("jax_enable_compilation_cache", False)
    _cc.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", True)
        _cc.reset_cache()


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
