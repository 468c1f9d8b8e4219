"""Helpers that the port's test files share."""
import contextlib
import functools

import jax
import numpy as np
import torch

# XLA's lowest backend optimisation level, without LLVM's costly passes.  The
# JAX references the port is held against are small programs, run once or
# twice: their compile, not their run, sets a test's time, and so it takes
# 30–50% less.
O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jit_o0(fn=None, **kwargs):
    """``jax.jit(fn, **kwargs)`` compiled at XLA's lowest backend
    optimisation level (``O0``); usable as a decorator."""
    if fn is None:
        return functools.partial(jit_o0, **kwargs)
    return jax.jit(fn, compiler_options=O0, **kwargs)


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


def port_model(tkern, t, noise, time_last=True):
    """(the JAX package's LGSSMTL (LGSSM for ``time_last=False``) holding the
    port's arrays, the port's model): the port kernel's model of the times
    ``t``, no autograd, handed to the JAX engines as numpy.  The JAX
    package's own build of a model costs a compile of 3–5 s a kernel and
    length on the CPU; the port's build is held against it in
    test_torch_sde*.py and test_torch_rbf_transitions.py."""
    from parallel_gps_tpu.types import LGSSM, LGSSMTL

    R = torch.tensor([[noise]], dtype=torch.float64)
    with torch.no_grad():
        ssm = (tkern.get_ssm_tl if time_last else tkern.get_ssm)(torch.tensor(np.asarray(t)), R)
    return (LGSSMTL if time_last else LGSSM)(*(jax.numpy.asarray(x.numpy()) for x in ssm)), ssm
