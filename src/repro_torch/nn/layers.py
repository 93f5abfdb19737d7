"""Parameter construction and basic layers (the reference's nn/layers.py).

Models are described once by a structure function that receives a leaf
constructor ``leaf(name, shape, axes, init=..., scale=...)`` and returns
the parameter tree (plain dicts and lists of tensors, with the
reference's key names and shapes). The same structure with different
leaf constructors yields:

  * real parameters     (:func:`init_leaf`, from a ``torch.Generator``)
  * meta tensors        (:func:`abstract_leaf`: shapes and dtypes, no
                         memory; the dry-run's stand-ins)
  * logical-axis trees  (:func:`axes_leaf`: :class:`Axes` leaves, read by
                         ``dist/shardings.py``)

so parameters, dry-run stand-ins and sharding specs cannot diverge.
:func:`init_leaf` draws in struct order with the reference's
distributions; the draws differ from ``jax.random``'s, so tests hand the
reference's parameters over through ``models.lm.params_from_numpy``
instead.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
import torch.nn.functional as F

Leaf = Callable[..., torch.Tensor]

# the inits kept in float32 whatever the parameter dtype
F32_INITS = frozenset({"ssm_A", "dt_bias", "lru_lambda"})


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical-axis names of one tensor, one per dimension. A leaf of an
    axes tree (not a container), so an axes tree has the structure of
    the tensor tree it describes."""

    names: tuple

    def __iter__(self):
        return iter(self.names)


def init_leaf(gen: torch.Generator, dtype: torch.dtype) -> Leaf:
    """Leaves on ``gen.device`` in ``dtype``, with the reference's
    distributions: ``normal`` (std 1/sqrt(fan_in) unless ``scale``),
    ``embed`` (std 0.02 unless ``scale``), ``zeros``, ``ones``, and in
    float32 whatever ``dtype``, as the reference keeps them: ``ssm_A`` (log of
    Uniform[1, 16]), ``dt_bias`` (softplus⁻¹ of dt, log dt uniform in
    [log dt_min, log dt_max], ``scale`` = (dt_min, dt_max)) and
    ``lru_lambda`` (Λ with a = exp(-8 softplus(Λ)) uniform in [0.9,
    0.999]). Normals are drawn in float32 and then cast, as the
    reference does."""
    device = gen.device

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return u.mul_(hi - lo).add_(lo)

    def leaf(name, shape, axes, init="normal", scale=None):
        if init in ("normal", "embed"):
            if init == "normal":
                fan_in = shape[-2] if len(shape) >= 2 else shape[0]
                std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
            else:
                std = scale if scale is not None else 0.02
            x = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32)
            return x.mul_(std).to(dtype)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "ssm_A":
            return torch.log(uniform(shape, 1.0, 16.0))
        if init == "dt_bias":
            lo, hi = scale or (0.001, 0.1)
            dt = torch.exp(uniform(shape, math.log(lo), math.log(hi)))
            return dt + torch.log(-torch.expm1(-dt))
        if init == "lru_lambda":
            # c * softplus(Λ) = -log a with c = 8
            x = -torch.log(uniform(shape, 0.9, 0.999)) / 8.0
            return torch.log(torch.expm1(x))
        raise ValueError(f"unknown init {init!r} ({name})")

    return leaf


def abstract_leaf(dtype: torch.dtype) -> Leaf:
    """Meta tensors of each leaf's shape, in ``dtype`` (float32 for the
    inits in :data:`F32_INITS`, as :func:`init_leaf` makes them)."""
    def leaf(name, shape, axes, init="normal", scale=None):
        dt = torch.float32 if init in F32_INITS else dtype
        return torch.empty(shape, dtype=dt, device="meta")

    return leaf


def axes_leaf() -> Leaf:
    """Each leaf's logical axes, as an :class:`Axes`."""
    def leaf(name, shape, axes, init="normal", scale=None):
        assert len(axes) == len(shape), (name, shape, axes)
        return Axes(tuple(axes))

    return leaf


# ---------------------------------------------------------------------------
# DTensor versions
# ---------------------------------------------------------------------------

# The DTensor versions of the model's functions that DTensor cannot run
# as written (no sharding strategy, or a slow or gathering one), keyed by
# the function :func:`shardable` returns. ``dist/sharded_ops.py`` fills
# it when imported; empty, every function runs as written.
SHARDED: dict[Callable, Callable] = {}


def shardable(fn: Callable) -> Callable:
    """``fn``, or the version registered for it in :data:`SHARDED`,
    called as ``version(fn, *args, **kwargs)``: on plain tensors it runs
    ``fn`` as it is, on DTensors it lays them out and runs ``fn`` on each
    rank's shards or redistributes around it. The model's modules stay
    free of DTensor code."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        version = SHARDED.get(call)
        if version is None:
            return fn(*args, **kwargs)
        return version(fn, *args, **kwargs)

    return call


# ---------------------------------------------------------------------------
# Layers (plain functions over param dicts)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics, in the reference's order: the
    mean of squares in float32, its rsqrt cast to x's dtype, then
    ``(x * inv) * (1 + scale)`` in x's dtype."""
    dtype = x.dtype
    xf = x.float()
    ss = (xf * xf).sum(dim=-1)
    inv = torch.rsqrt(ss / x.shape[-1] + eps)[..., None].to(dtype)
    return (x * inv) * (1.0 + scale.float()).to(dtype)


@shardable
def dense(x: torch.Tensor, w: torch.Tensor,
          b: torch.Tensor | None = None) -> torch.Tensor:
    out = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def mlp_struct(leaf: Leaf, prefix: str, d: int, d_ff: int, kind: str) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": leaf(f"{prefix}.w_gate", (d, d_ff), ("embed", "mlp")),
            "w_up": leaf(f"{prefix}.w_up", (d, d_ff), ("embed", "mlp")),
            "w_down": leaf(f"{prefix}.w_down", (d_ff, d), ("mlp", "embed")),
        }
    return {  # plain 2-matmul MLP
        "w_up": leaf(f"{prefix}.w_up", (d, d_ff), ("embed", "mlp")),
        "w_down": leaf(f"{prefix}.w_down", (d_ff, d), ("mlp", "embed")),
    }


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch to erf
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else gelu
        h = act(dense(x, p["w_gate"])) * dense(x, p["w_up"])
        return dense(h, p["w_down"])
    return dense(gelu(dense(x, p["w_up"])), p["w_down"])
