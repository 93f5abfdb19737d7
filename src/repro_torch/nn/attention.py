"""Attention for the LMs: GQA, RoPE or M-RoPE, qk-norm, QKV bias, local
windows, full-sequence (prefill) attention and ring-buffer decode caches.

Full-sequence attention goes through the kernel registry's ``attention``
op — on the ``cuda`` backend the hand-written flash-attention kernel —
with the causal (and optional window) mask of the reference's
``_sdpa_chunked`` / ``_sdpa_banded``. Single-token decode stays plain
PyTorch over the cache, as in the reference.

On DTensors (a sharded run) the registry's op, and decode's attention
over the cache, run on each rank's shard: :func:`_attend`'s version in
``dist/sharded_ops.py``.

Decode keeps a ring buffer of W entries for local layers (pos % W
indexing) and a full max_len buffer for global layers. The port updates
the buffers in place (the reference donates and returns them);
:func:`attn_decode` still returns them.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import registry
from repro_torch.models.config import ModelConfig
from repro_torch.nn.layers import Leaf, dense, rms_norm, shardable
from repro_torch.nn.rope import apply_mrope, apply_rope

NEG = -0.7 * torch.finfo(torch.float32).max


def attn_struct(leaf: Leaf, prefix: str, cfg: ModelConfig) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": leaf(f"{prefix}.wq", (d, hq * dh), ("embed", "heads")),
        "wk": leaf(f"{prefix}.wk", (d, hkv * dh), ("embed", "kv_heads")),
        "wv": leaf(f"{prefix}.wv", (d, hkv * dh), ("embed", "kv_heads")),
        "wo": leaf(f"{prefix}.wo", (hq * dh, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = leaf(f"{prefix}.bq", (hq * dh,), ("heads",), init="zeros")
        p["bk"] = leaf(f"{prefix}.bk", (hkv * dh,), ("kv_heads",), init="zeros")
        p["bv"] = leaf(f"{prefix}.bv", (hkv * dh,), ("kv_heads",), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = leaf(f"{prefix}.q_norm", (dh,), ("head_dim",), init="zeros")
        p["k_norm"] = leaf(f"{prefix}.k_norm", (dh,), ("head_dim",), init="zeros")
    return p


@shardable
def _heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    """(B, S, n * dh) -> contiguous (B, n, S, dh)."""
    b, s, _ = x.shape
    return x.reshape(b, s, n, dh).transpose(1, 2).contiguous()


@shardable
def _merge_heads(out: torch.Tensor) -> torch.Tensor:
    """(B, n, S, dh) -> (B, S, n * dh)."""
    b, n, s, dh = out.shape
    return out.transpose(1, 2).reshape(b, s, n * dh)


@shardable
def _attend(op, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw):
    """``op(q, k, v, **kw)``: q (B, Hq, Sq, dh), k/v (B, Hkv, Skv, dh)."""
    return op(q, k, v, **kw)


def _project_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = _heads(dense(x, p["wq"], p.get("bq")), hq, dh)
    k = _heads(dense(x, p["wk"], p.get("bk")), hkv, dh)
    v = _heads(dense(x, p["wv"], p.get("bv")), hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _rope_qk(q, k, positions, cfg: ModelConfig):
    """RoPE with (B, S) positions, or M-RoPE with (3, B, S) ones."""
    if cfg.rope_kind == "mrope":
        return (apply_mrope(q, positions, cfg.rope_theta,
                            cfg.mrope_sections),
                apply_mrope(k, positions, cfg.rope_theta,
                            cfg.mrope_sections))
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta))


def attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, *, window: int | None = None,
               return_kv: bool = False, backend=None):
    """Full-sequence (prefill) attention. x (B,S,D) -> (B,S,D); with
    ``return_kv`` also the post-RoPE (k, v), each (B, Hkv, S, dh).

    The attention itself is the registry's ``attention`` op (``backend``:
    ``cuda`` or ``reference``; None reads the registry's environment
    variables, then ``cuda``), causal, with ``window`` and the scale
    dh ** -0.5."""
    dh = cfg.head_dim
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope_qk(q, k, positions, cfg)
    out = _attend(registry.resolve(backend, op="attention").attention,
                  q, k, v, causal=True, window=window, scale=dh ** -0.5)
    out = dense(_merge_heads(out).to(x.dtype), p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def attn_cache_struct(cfg: ModelConfig, batch: int, max_len: int, window,
                      device: torch.device | str | None = None) -> dict:
    w = min(max_len, window) if window is not None else max_len
    shape = (batch, cfg.n_kv_heads, w, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def attn_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict,
                pos: int, *, window: int | None = None):
    """Single-token decode. x (B,1,D); pos the new token's position;
    cache k/v (B,Hkv,W,dh) where W = window (ring buffer) or max_len.
    Writes the new k/v into the cache in place and returns (out, cache)."""
    b = x.shape[0]
    q, k_new, v_new = _project_qkv(p, x, cfg)
    # M-RoPE rotates the new token by the same pos in all three rows
    shape = (3, b, 1) if cfg.rope_kind == "mrope" else (b, 1)
    pos1 = torch.full(shape, pos, dtype=torch.int32, device=x.device)
    q, k_new = _rope_qk(q, k_new, pos1, cfg)
    k, v = cache["k"], cache["v"]
    w = k.shape[2]
    slot = pos % w
    k[:, :, slot] = k_new[:, :, 0].to(k.dtype)
    v[:, :, slot] = v_new[:, :, 0].to(v.dtype)
    # absolute position held by each slot s: pos - ((pos - s) mod w)
    s_idx = torch.arange(w, device=x.device)
    kpos = pos - torch.remainder(pos - s_idx, w)
    valid = kpos >= 0
    if window is not None:
        valid &= kpos > pos - window
    out = _attend(functools.partial(_decode_attention, valid=valid), q, k, v)
    return dense(_merge_heads(out).to(x.dtype), p["wo"]), cache


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      valid: torch.Tensor) -> torch.Tensor:
    """One query over the cache in float32: q (B, Hq, 1, dh), k/v (B,
    Hkv, W, dh), ``valid`` the (W,) slots it may read."""
    b, hq, _, dh = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, 1, dh).float() * dh ** -0.5
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    logits = logits.masked_fill(~valid, NEG)
    prob = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", prob, v.float())
    return out.reshape(b, hq, 1, dh)


def attn_prefill_cache(k: torch.Tensor, v: torch.Tensor, max_len: int,
                       window) -> dict:
    """Build a decode cache from prefill-computed (post-RoPE) k/v."""
    b, hkv, s, dh = k.shape
    if window is not None and window < max_len:
        # the last w positions, laid out by absolute position mod w
        # (for s < w the reference's slice does not fit its slots; here
        # positions 0..s-1 simply land in slots 0..s-1)
        w = window
        tail = torch.arange(max(0, s - w), s, device=k.device)
        buf_k = k.new_zeros((b, hkv, w, dh))
        buf_v = v.new_zeros((b, hkv, w, dh))
        buf_k[:, :, tail % w] = k[:, :, tail]
        buf_v[:, :, tail % w] = v[:, :, tail]
        return {"k": buf_k, "v": buf_v}
    buf_k = k.new_zeros((b, hkv, max_len, dh))
    buf_v = v.new_zeros((b, hkv, max_len, dh))
    buf_k[:, :, :s] = k
    buf_v[:, :, :s] = v
    return {"k": buf_k, "v": buf_v}
