"""Flash attention: ``softmax(q kᵀ · scale + mask) v`` with GQA, causal
masking and an optional sliding window.

The port of ``repro.kernels.flash_attention.flash_attention``; the CUDA
kernel is ``csrc/flash_attention.cu``, an online-softmax kernel that walks
64-row kv tiles per 64-row q tile (its header says what bounds it). CPU
tensors take the plain version in ``ref.py``; CUDA tensors launch the
kernel or raise. Unlike the Pallas kernel, no length has to be a block
multiple: the kernel masks the ragged tails itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernel's dtype codes


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, Dh), k/v (B, Hkv, Skv, Dh), all float32 or all
    bfloat16, Hq % Hkv == 0, Dh <= 128 -> (B, Hq, Sq, Dh) in q's dtype.

    Query row i sits at position Skv - Sq + i; ``window`` keeps keys
    within [pos - window + 1, pos]. ``scale`` defaults to Dh ** -0.5. A
    row with no key left (Sq > Skv under ``causal``, or a window that
    excludes every key) gives 0."""
    if _lib.on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.check("flash_attention", name, t, q.dtype, 4)
    b, hq, sq, dh = q.shape
    b2, hkv, skv, dh2 = k.shape
    if (b2, dh2) != (b, dh) or v.shape != k.shape or hkv == 0 \
            or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match (need equal B and Dh, Hq % Hkv == 0)")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {dh} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    if b * hq > 65535:
        raise ValueError(f"flash_attention: B * Hq = {b * hq} exceeds the "
                         f"grid limit 65535")
    if window is not None and window < 0:
        raise ValueError(f"flash_attention: window must be None or >= 0, "
                         f"got {window}")
    out = torch.empty_like(q)
    if out.numel():
        _lib.launch("flash_attention", q, k, v, out, b, hq, hkv, sq, skv, dh,
                    dh ** -0.5 if scale is None else scale, int(causal),
                    -1 if window is None else window, DTYPES[q.dtype],
                    device=q.device)
    return out
