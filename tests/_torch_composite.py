"""Helpers that test_torch_composite_*.py share: the composite kernels of
the JAX package's own tests, built in both packages from the same values,
and the nested spec that carries a JAX kernel tree across."""
import numpy as np
import torch

import parallel_gps_tpu.kernels as jk
from parallel_gps_torch import kernels as tk
from parallel_gps_torch.models.ssgp import kernel_from_spec

CPU64 = dict(dtype=torch.float64, device="cpu")


def jax_spec(k):
    """The port's kernel spec (models/ssgp.py::kernel_from_spec) of a JAX
    kernel tree: its constrained values as numpy, its static fields."""
    name = type(k).__name__
    if name in ("Sum", "Product"):
        return (name, [jax_spec(c) for c in k.kernels]) + (({"balancing_iter": k.balancing_iter},) if k.balancing_iter >= 0 else ())
    fields = {"variance": np.asarray(k.variance), "lengthscales": np.asarray(k.lengthscales)}
    if name == "Periodic":
        fields.update(period=np.asarray(k.period), order=k.order)
    if name == "RBF":
        fields.update(order=k.order, balancing_iter=k.balancing_iter)
    return (name, fields)


def port_kernel(k):
    """The port's kernel of a JAX kernel tree, f64 on the CPU."""
    return kernel_from_spec(jax_spec(k), **CPU64)


def composites():
    """(id, JAX kernel) of test_pallas_dt.py:90-105's composite cases."""
    return [
        ("sum_m32_m12", jk.Matern32(1.1, 0.5) + jk.Matern12(0.8, 0.3)),
        ("prod_m32_m32", jk.Matern32(1.2, 0.6) * jk.Matern32(0.9, 0.4)),
        ("periodic2", jk.Periodic(1.3, 0.8, period=0.7, order=2)),
        ("quasiperiodic", jk.Periodic(1.0, 1.0, period=0.5, order=1) * jk.Matern12(1.0, 0.7)),
        ("co2_shape", jk.Periodic(1.0, 1.0, period=0.5, order=1) * jk.Matern32(0.5, 0.8) + jk.Matern32(1.0, 1.5)),
    ]


def qp():
    """The quasi-periodic covariance of experiments/common.py:104-112 at
    --qp-order 1: Periodic(1, 1, period=1, order=1) × Matern32(1, 1), d = 8."""
    return jk.Periodic(variance=1.0, lengthscales=1.0, period=1.0, order=1) * jk.Matern32(variance=1.0, lengthscales=1.0)


def data(T, seed, nan_frac=0.1):
    rng = np.random.RandomState(seed)
    t = np.sort(rng.rand(T))
    y = np.sin(12.0 * t) + 0.3 * rng.randn(T)
    y[rng.rand(T) < nan_frac] = np.nan
    return t, y


__all__ = ["CPU64", "composites", "data", "jax_spec", "port_kernel", "qp", "tk"]
