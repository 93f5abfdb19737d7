"""RecurrentGemma / Griffin recurrent block with the RG-LRU (the
reference's nn/rglru.py).

Block:  x ->  [linear_x -> causal conv(4) -> RG-LRU]  ⊙  [linear_y -> GeLU]
           -> linear_out

RG-LRU (Real-Gated Linear Recurrent Unit):
    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    log a_t = -c · softplus(Λ) · r_t      (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The reference evaluates the recurrence with ``jax.lax.associative_scan``;
torch has none, so :func:`linear_scan` is a log-depth doubling scan
(Hillis–Steele over (a, u) pairs: log2 S steps of elementwise products
over (B, S, W), float32). Decode is the closed-form single step on a
(B, W) state; it writes the new state into the cache dict it is given.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.nn.layers import Leaf, dense, gelu


def _width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def rglru_struct(leaf: Leaf, prefix: str, cfg: ModelConfig) -> dict:
    d, w = cfg.d_model, _width(cfg)
    cw = cfg.rglru.conv_width
    return {
        "w_x": leaf(f"{prefix}.w_x", (d, w), ("embed", "lru")),
        "w_y": leaf(f"{prefix}.w_y", (d, w), ("embed", "lru")),
        "conv_w": leaf(f"{prefix}.conv_w", (cw, w), ("conv_w", "lru"), scale=0.5),
        "conv_b": leaf(f"{prefix}.conv_b", (w,), ("lru",), init="zeros"),
        "w_a": leaf(f"{prefix}.w_a", (w, w), ("lru", "lru_gate")),
        "b_a": leaf(f"{prefix}.b_a", (w,), ("lru_gate",), init="zeros"),
        "w_i": leaf(f"{prefix}.w_i", (w, w), ("lru", "lru_gate")),
        "b_i": leaf(f"{prefix}.b_i", (w,), ("lru_gate",), init="zeros"),
        "lam": leaf(f"{prefix}.lam", (w,), ("lru",), init="lru_lambda"),
        "w_out": leaf(f"{prefix}.w_out", (w, d), ("lru", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, the reference's sum of shifted products in
    its order. x (B, L, C), w (K, C), b (C,)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _gates(p: dict, xr: torch.Tensor, cfg: ModelConfig):
    c = cfg.rglru.c_exponent
    r = torch.sigmoid(dense(xr, p["w_a"], p["b_a"]).float())
    i = torch.sigmoid(dense(xr, p["w_i"], p["b_i"]).float())
    log_a = -c * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i * xr.float())
    return a, gated_in


def linear_scan(a: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + u_t along dim 1 with h_{-1} = 0, in log2 S
    doubling steps (each pair (a, u) composed with the one ``step``
    before it). Products of a only shrink, so no step can overflow."""
    a, h = a.clone(), u.clone()
    s, step = a.shape[1], 1
    while step < s:
        h_new = h.clone()
        h_new[:, step:] += a[:, step:] * h[:, :-step]
        a_new = a.clone()
        a_new[:, step:] *= a[:, :-step]
        a, h = a_new, h_new
        step *= 2
    return h


def rglru_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                return_state: bool = False):
    """x (B, S, D) -> (B, S, D); with ``return_state`` also the decode
    cache: the final hidden state and the conv tail (the pre-conv branch
    input), both float32."""
    xpre = dense(x, p["w_x"])
    xr = _causal_conv(xpre, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    a, u = _gates(p, xr, cfg)                       # (B, S, W) float32
    h = linear_scan(a, u)
    y = h.to(x.dtype) * gelu(dense(x, p["w_y"]))
    out = dense(y, p["w_out"])
    if return_state:
        cache = {"h": h[:, -1].float(),
                 "conv": xpre[:, -(cfg.rglru.conv_width - 1):, :].float()}
        return out, cache
    return out


def rglru_cache_struct(cfg: ModelConfig, batch: int,
                       device: torch.device | str | None = None) -> dict:
    w = _width(cfg)
    shapes = {"h": (batch, w), "conv": (batch, cfg.rglru.conv_width - 1, w)}
    return {k: torch.zeros(v, dtype=torch.float32, device=device)
            for k, v in shapes.items()}


def rglru_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Single-token decode. x (B, 1, D). Puts the new state into
    ``cache`` and returns (out, cache)."""
    xpre = dense(x, p["w_x"])                        # (B, 1, W)
    window = torch.cat([cache["conv"].to(x.dtype), xpre], dim=1)
    xr = (window * p["conv_w"].to(x.dtype)[None]).sum(dim=1, keepdim=True) \
        + p["conv_b"].to(x.dtype)[None, None]
    a, u = _gates(p, xr, cfg)                        # (B, 1, W)
    h = a[:, 0] * cache["h"] + u[:, 0]               # (B, W)
    y = h[:, None].to(x.dtype) * gelu(dense(x, p["w_y"]))
    cache["h"], cache["conv"] = h, window[:, 1:].float()
    return dense(y, p["w_out"]), cache
