"""Parameter construction and basic layers (the reference's nn/layers.py).

Models are described once by a structure function that receives a leaf
constructor ``leaf(name, shape, axes, init=..., scale=...)`` and returns
the parameter tree (plain dicts and lists of tensors, with the
reference's key names and shapes). :func:`init_leaf` draws real
parameters from a ``torch.Generator`` on its own device, in struct order,
with the reference's distributions; the draws differ from
``jax.random``'s, so tests hand the reference's parameters over through
``models.lm.params_from_numpy`` instead.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

Leaf = Callable[..., torch.Tensor]


def init_leaf(gen: torch.Generator, dtype: torch.dtype) -> Leaf:
    """Leaves on ``gen.device`` in ``dtype``: ``normal`` (std
    1/sqrt(fan_in) unless ``scale``), ``embed`` (std 0.02 unless
    ``scale``), ``zeros``. Normals are drawn in float32 and then cast,
    as the reference does."""
    device = gen.device

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
        raise NotImplementedError(
            f"init {init!r} ({name}) belongs to a block kind that is not "
            f"ported yet (ROADMAP.md, Queue 1 item 7)")

    return leaf


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


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch to erf
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else _gelu
        h = act(dense(x, p["w_gate"])) * dense(x, p["w_up"])
        return dense(h, p["w_down"])
    return dense(_gelu(dense(x, p["w_up"])), p["w_down"])
