"""State-space GP regression model (counterpart:
parallel_gps_tpu/models/ssgp.py).

``StateSpaceGP`` is an ``nn.Module`` holding the sorted training times and
observations (NaN = missing) as buffers, a kernel module and a
softplus-unconstrained noise variance.  Its entry points pick an engine from
what they can observe (``engine``): the sequential oracle for
``parallel=False``; the dt-engine (kalman/dt.py) for a kernel with a
closed-form transition family within its kernels' range (the Matérn kernels,
d ≤ 3; RBF of order ≤ 8; Periodic, Sum and Product of such kernels up to
d = 8, as the reference's ``lml_dt`` / ``pkfs_dt`` route); the
plane-streaming strip engine (kalman/strip.py) for any other
kernel with d ≤ 8; the plain time-last engine above that (RBF above order
8 through the Padé exponential).  ``stable=True`` takes the square-root
engine (kalman/sqrt.py) for every kernel.  The dt and strip engines run
hand-written CUDA kernels when the model lives on a CUDA device and their
plain PyTorch versions on the CPU.  A model is built on the card unless the
caller names another device.

Hyperparameters of shape (C,) — given to ``from_numpy``, or substituted by
``torch.func.functional_call`` — are C chains of a sampler (or C models) over
the one data set, for every kernel: the LML is then (C,), one launch of the
batched kernels for all chains on the dt and strip engines (kalman/dt.py,
kalman/batched.py), the plain time-last engine with a batch axis above
d = 8 and the square-root engine's leading batch axis, and ``predict_f``
gives (C, M, 1).  It is the port's
``jax.vmap(log_post)`` and ``jax.vmap(lambda m: m.predict_f(X))``.  The
sequential engine takes no batch axis (ROADMAP.md A14).

Prediction merges the training and (sorted) query times with a
searchsorted merge, puts NaN observations at the queries, smooths the
merged series and reads off the H-projections.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor, nn

from parallel_gps_torch import config
from parallel_gps_torch.kalman import dt, strip
from parallel_gps_torch.kalman.batched import batched_strip_smoother, batched_strip_smoother_plain
from parallel_gps_torch.kalman.sequential import kf, kfs
from parallel_gps_torch.kalman.sqrt import sqrt_lml_kernel, sqrt_pkfs_kernel
from parallel_gps_torch.kalman.timelast import lml_tl, pkf_from_tl, pkfs_from_tl
from parallel_gps_torch.kernels.base import Product, SDEKernel, Sum
from parallel_gps_torch.kernels.matern import Matern12, Matern32, Matern52
from parallel_gps_torch.kernels.periodic import Periodic
from parallel_gps_torch.kernels.rbf import RBF
from parallel_gps_torch.models.params import inv_softplus, softplus

KERNELS = {"Matern12": Matern12, "Matern32": Matern32, "Matern52": Matern52, "RBF": RBF, "Periodic": Periodic}
COMBINATORS = {"Sum": Sum, "Product": Product}
# Each leaf's constrained values and static fields, as a spec names them.
_VALUES = ("variance", "lengthscales", "period")
_STATIC = ("order", "balancing_iter")


def kernel_from_spec(spec, dtype=None, device=None) -> SDEKernel:
    """A kernel from a nested spec of numpy values: a leaf ``(name, {field:
    value})`` — the constrained ``variance``, ``lengthscales`` (and
    ``period``) and the static ``order`` / ``balancing_iter`` where the kernel
    has them — or ``("Sum" | "Product", [spec, ...])``, optionally with
    ``{"balancing_iter": n}`` third."""
    name, body, *rest = spec
    if name in COMBINATORS:
        return COMBINATORS[name](*(kernel_from_spec(s, dtype, device) for s in body), **(rest[0] if rest else {}))
    values = {k: np.asarray(v, dtype=np.float64) if k in _VALUES else v for k, v in body.items()}
    return KERNELS[name](dtype=dtype, device=device, **values)


def kernel_spec(kernel: SDEKernel):
    """The inverse of ``kernel_from_spec``: constrained values as numpy
    arrays."""
    if isinstance(kernel, (Sum, Product)):
        body = [kernel_spec(k) for k in kernel.kernels]
        return (type(kernel).__name__, body) + (({"balancing_iter": kernel.balancing_iter},) if kernel.balancing_iter >= 0 else ())
    fields = {k: getattr(kernel, k).detach().cpu().numpy() for k in _VALUES if hasattr(kernel, k)}
    fields.update({k: getattr(kernel, k) for k in _STATIC if k in vars(kernel)})
    return (type(kernel).__name__, fields)


def merge_sorted(a: Tensor, b: Tensor, a_data, b_data):
    """Stable merge of two sorted 1-D tensors plus parallel payloads.

    Returns (merged_keys, merged_payloads, b_positions).  A b-element goes
    before a-elements equal to it (left-side searchsorted, as
    ``jnp.searchsorted``'s default).  Unlike the JAX version, which returns
    a boolean mask, the positions of the b-elements are returned, so no
    data-dependent ``nonzero`` is needed."""
    na, nb = a.shape[0], b.shape[0]
    b_pos = torch.searchsorted(a, b) + torch.arange(nb, device=a.device)
    a_pos = torch.arange(na, device=a.device) + torch.searchsorted(b, a, right=True)

    def scatter(u, v):
        out = torch.empty((na + nb,) + tuple(u.shape[1:]), dtype=u.dtype, device=u.device)
        out[a_pos] = u
        out[b_pos] = v
        return out

    return scatter(a, b), tuple(scatter(u, v) for u, v in zip(a_data, b_data)), b_pos


def _as_tensor(x, dtype, device) -> Tensor:
    """A tensor or array-like (copied, so read-only arrays are fine)."""
    if not isinstance(x, Tensor):
        x = torch.tensor(np.asarray(x))
    return x.to(dtype=dtype, device=device)


class StateSpaceGP(nn.Module):
    def __init__(
        self, ts: Tensor, ys: Tensor, kernel: SDEKernel, raw_noise_variance: Tensor, parallel: bool = True,
        stable: bool = False,
    ):
        """``raw_noise_variance``: softplus⁻¹ of the noise variance (use
        ``create`` or ``from_numpy`` to build from constrained values)."""
        super().__init__()
        self.register_buffer("ts", ts.reshape(-1))
        self.register_buffer("ys", ys.reshape(-1))
        self.kernel = kernel
        self.raw_noise_variance = nn.Parameter(raw_noise_variance)
        self.parallel = parallel
        self.stable = stable

    @property
    def noise_variance(self) -> Tensor:
        return softplus(self.raw_noise_variance)

    @classmethod
    def create(
        cls,
        data,
        kernel: SDEKernel,
        noise_variance: float = 1.0,
        parallel: bool = True,
        dtype=None,
        device=None,
        mesh=None,
        stable: bool = False,
    ) -> "StateSpaceGP":
        """``data`` = (ts, ys): sorted times and observations (arrays or
        tensors, NaN = missing).  ``device=None`` is the card
        (``config.default_device()``); the CPU must be asked for.
        ``parallel=False`` runs the sequential Kalman filter and smoother, a
        Python loop over time (the oracle; kalman/sequential.py).
        ``stable=True`` runs the square-root engine (kalman/sqrt.py):
        covariances carried as triangular factors, PSD by construction at
        any conditioning, for d ≳ 8 in float32 at large T (the JAX package's
        replacement for the reference's float64-only d ≥ 12 sweeps); it
        needs ``parallel=True`` and no ``mesh``."""
        if stable:
            if not parallel:
                raise ValueError("stable=True requires parallel=True")
            if mesh is not None:
                raise ValueError("stable=True is single-device (the sqrt engine has no sharded variant); drop mesh or stable")
        if mesh is not None:
            raise NotImplementedError("mesh= (time-sharded engines) is ROADMAP A13")
        dtype = dtype or config.default_float()
        device = config.resolve_device(device)
        ts, ys = (_as_tensor(x, dtype, device) for x in data)
        kernel = kernel.to(dtype=dtype, device=device)
        nv = torch.as_tensor(np.asarray(noise_variance, dtype=np.float64))
        return cls(ts, ys, kernel, inv_softplus(nv).to(dtype=dtype, device=device), parallel=parallel, stable=stable)

    @classmethod
    def from_numpy(
        cls,
        ts,
        ys,
        kernel: str = "Matern52",
        variance=1.0,
        lengthscales=1.0,
        noise_variance=1.0,
        dtype=None,
        device=None,
        parallel: bool = True,
        stable: bool = False,
        **kernel_options,
    ) -> "StateSpaceGP":
        """Model from numpy arrays of constrained values: the same
        quantities a JAX ``StateSpaceGP`` holds (``ts``, ``ys``,
        ``kernel.variance``, ``kernel.lengthscales``, ``noise_variance``),
        so both packages compute the same thing.  ``kernel`` is a kernel's
        name, or a nested spec (``kernel_from_spec``) such as
        ``("Product", [("Periodic", {"variance": 1.0, "lengthscales": 1.0,
        "period": 1.0, "order": 1}), ("Matern32", {...})])``, which carries
        its own values (``variance`` and ``lengthscales`` are then unused).  Each of the three may be
        an array of shape (C,) — a batch of JAX models' hyperparameters, e.g.
        ``jax.vmap``-stacked leaves: C chains over the one data set (module
        docstring).  ``kernel_options``: the kernel's static fields
        (``order`` and ``balancing_iter`` of "RBF", ``balancing_iter`` of
        "Matern52").  ``parallel`` and ``stable`` as in ``create``."""
        dtype = dtype or config.default_float()
        device = config.resolve_device(device)
        variance, lengthscales, noise_variance = (
            np.asarray(x, dtype=np.float64) for x in (variance, lengthscales, noise_variance)
        )
        if isinstance(kernel, str):
            k = KERNELS[kernel](variance, lengthscales, dtype=dtype, device=device, **kernel_options)
        else:
            k = kernel_from_spec(kernel, dtype, device)
        return cls.create((ts, ys), k, noise_variance, parallel=parallel, dtype=dtype, device=device, stable=stable)

    def to_numpy(self) -> dict:
        """The constrained hyperparameters as numpy arrays and, for an RBF
        kernel, its static fields ``order`` and ``balancing_iter`` (the
        inverse of ``from_numpy``'s ``variance``, ``lengthscales``,
        ``noise_variance`` and ``kernel_options``); for a Periodic, Sum or
        Product kernel, ``kernel`` (its spec, ``kernel_spec``) and
        ``noise_variance``."""
        if isinstance(self.kernel, (Periodic, Sum, Product)):
            return {"kernel": kernel_spec(self.kernel), "noise_variance": self.noise_variance.detach().cpu().numpy()}
        values = {
            "variance": self.kernel.variance, "lengthscales": self.kernel.lengthscales,
            "noise_variance": self.noise_variance,
        }
        out = {k: v.detach().cpu().numpy() for k, v in values.items()}
        if isinstance(self.kernel, RBF):
            out.update(order=self.kernel.order, balancing_iter=self.kernel.balancing_iter)
        return out

    def engine(self):
        """("sequential" | "sqrt" | "dt" | "strip" | "timelast", transition):
        the engine the entry points run, and the kernel's
        ``transition_coeffs()`` where the dt-engine takes them."""
        if self.stable:
            return "sqrt", None
        d = self.kernel.state_dim
        if not self.parallel:
            if self.batched:
                raise NotImplementedError(
                    "hyperparameters with a batch axis (chains) run on the parallel engines (parallel=True); chains "
                    "on the sequential engine are ROADMAP.md A14"
                )
            return "sequential", None
        transition = self.kernel.transition_coeffs()
        if transition is not None and dt.fits(transition[0], d):
            return "dt", transition
        return ("strip" if d <= strip.MAX_KERNEL_D else "timelast"), None

    @property
    def batched(self) -> bool:
        """Whether the hyperparameters carry a batch axis (C chains)."""
        return any(p.dim() for p in self.parameters())

    def _R(self) -> Tensor:
        """The noise variance as R: (1, 1), or (C, 1, 1) for C chains."""
        nv = self.noise_variance
        return nv.reshape(-1, 1, 1) if nv.dim() else nv.reshape(1, 1)

    def log_marginal_likelihood(self) -> Tensor:
        """LML of the data, differentiable in the hyperparameters.  On the dt
        and strip engines the backward is the engine's smoother and the
        Fisher tail (kalman/dt.py::lml_dt, kalman/timelast.py::lml_tl); the
        sequential engine differentiates through its loop."""
        engine, transition = self.engine()
        if engine == "dt":
            return dt.lml_dt(self.kernel, self.ts, self.noise_variance, self.ys, transition)
        R = self._R()
        if engine == "sqrt":
            return sqrt_lml_kernel(self.kernel, self.ts, R, self.ys)
        if engine == "sequential":
            return kf(self.kernel.get_ssm(self.ts, R), self.ys, return_loglikelihood=True)[2]
        return lml_tl(self.kernel.get_ssm_tl(self.ts, R), self.ys, strip=engine == "strip")

    # Alias matching the reference method name.
    maximum_log_likelihood_objective = log_marginal_likelihood

    # Calling the module evaluates it: what ``torch.func.functional_call``
    # runs with substituted parameters (``inference.optim``).
    forward = log_marginal_likelihood

    def training_loss(self) -> Tensor:
        return -self.log_marginal_likelihood()

    @torch.no_grad()
    def predict_f(self, Xnew, full_cov: bool = False):
        """Posterior mean and marginal variance of f at ``Xnew`` (any order,
        inside or outside the data range), each (M, 1), or (C, M, 1) for C
        chains.  ``full_cov`` is accepted and ignored, as in the reference."""
        del full_cov
        X = _as_tensor(Xnew, self.ts.dtype, self.ts.device).reshape(-1)
        m = X.shape[0]
        lead = tuple(torch.broadcast_shapes(*(p.shape for p in self.parameters())))
        if m == 0:
            empty = torch.zeros(lead + (0, 1), dtype=self.ts.dtype, device=self.ts.device)
            return empty, empty.clone()
        order = torch.argsort(X)
        nan_ys = torch.full((m,), float("nan"), dtype=self.ys.dtype, device=self.ys.device)
        all_ts, (all_ys,), q_idx = merge_sorted(self.ts, X[order], (self.ys,), (nan_ys,))
        engine, transition = self.engine()
        inv_order = torch.argsort(order)
        if engine == "sqrt":
            # The square-root smoother over the merged series: the variance
            # ‖Nᵀhᵀ‖² ≥ 0 read off the factor, for every chain at once.
            sms, sNs = sqrt_pkfs_kernel(self.kernel, all_ts, self._R(), all_ys)
            h = self.kernel.get_sde().H[..., 0, :]  # (…, d)
            mean = (sms[..., q_idx, :] * h[..., None, :]).sum(-1)
            var = ((sNs[..., q_idx, :, :].transpose(-1, -2) @ h[..., None, :, None])[..., 0] ** 2).sum(-1)
            return mean[..., inv_order, None], var[..., inv_order, None]
        if self.batched:
            mean, var = self._predict_batched(engine, transition, all_ts, all_ys)
            return mean[:, q_idx][:, inv_order, None], var[:, q_idx][:, inv_order, None]
        R = self._R()
        if engine == "dt":
            g_tl, L_tl = dt.pkfs_dt(self.kernel, all_ts, R, all_ys, transition)
            h = self.kernel.get_sde().H[0]
        elif engine == "sequential":
            ssm = self.kernel.get_ssm(all_ts, R)
            sms, sPs = kfs(ssm, all_ys)
            g_tl, L_tl, h = sms.movedim(0, -1), sPs.movedim(0, -1), ssm.H[0]
        else:
            ssm = self.kernel.get_ssm_tl(all_ts, R)
            g_tl, L_tl = pkfs_from_tl(ssm, all_ys, strip=engine == "strip", time_first_out=False)
            h = ssm.H[0]
        mean = h @ g_tl[:, q_idx]  # (M,)
        var = torch.einsum("i,ijm,j->m", h, L_tl[:, :, q_idx], h)
        return mean[inv_order][:, None], var[inv_order][:, None]

    def _predict_batched(self, engine: str, transition, all_ts: Tensor, all_ys: Tensor):
        """The C chains' H-projections of the smoothed moments over the merged
        series, each (C, T): one filter and one smoother with its fused
        projection for all chains — the batched kernels on the dt engine's
        planes or on the strip engine's, the plain time-last engine with
        the batch axis above d = 8."""
        if engine == "dt":
            family, coeffs, sde, dts = dt._model_inputs(self.kernel, all_ts, transition)
            coeffs, P0, H, R, _ = dt.series_inputs(coeffs, sde, self.noise_variance)
            (b, C, _), (Fs, Qs) = dt._batched_filter_dt(family, coeffs, P0, H, R, dts, all_ys)
            return batched_strip_smoother(Fs, Qs, b, C, H, project=True)[2:]
        ssm = self.kernel.get_ssm_tl(all_ts, self._R())
        b, C = pkf_from_tl(ssm, all_ys, strip=engine == "strip")
        smoother = batched_strip_smoother if engine == "strip" else batched_strip_smoother_plain
        return smoother(ssm.Fs, ssm.Qs, b, C, ssm.H, project=True)[2:]
