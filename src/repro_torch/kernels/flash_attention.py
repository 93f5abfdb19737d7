"""Flash attention: ``softmax(q kᵀ · scale + mask) v`` with GQA, causal
masking and an optional sliding window.

The port of ``repro.kernels.flash_attention.flash_attention``, with two
CUDA kernels chosen statically by :func:`_route`:

  ``flash_attention_tc``  ``csrc/flash_attention_tc.cu``: bfloat16 with
                          head dim 64, 128 or 256 (recurrentgemma's) on
                          the tensor cores (wgmma, TMA, mbarriers). P is
                          rounded to bfloat16 before P V, because wgmma's
                          A operand is bfloat16; the Pallas kernel and the
                          plain version keep P in float32.
  ``flash_attention``     ``csrc/flash_attention.cu``: float32 at any head
                          dim up to 256, and bfloat16 at the head dims the
                          tensor-core kernel does not take; float32 FMA on
                          the CUDA cores.

Each source's header says what bounds it. CPU tensors take the plain
version in ``ref.py``; CUDA tensors launch a kernel or raise. Unlike the
Pallas kernel, no length has to be a block multiple: both kernels mask
the ragged tails themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

MAX_HEAD_DIM = 256                  # flash_attention.cu: any dh up to it
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' dtype codes
TC_HEAD_DIMS = (64, 128, 256)       # flash_attention_tc.cu: bfloat16 only


def _route(dtype: torch.dtype, dh: int) -> str:
    """The kernel (its launch counter's name) for inputs of ``dtype`` and
    head dim ``dh``: the tensor-core kernel for bfloat16 at a dh in
    ``TC_HEAD_DIMS``, else the CUDA-core kernel."""
    if dtype == torch.bfloat16 and dh in TC_HEAD_DIMS:
        return "flash_attention_tc"
    return "flash_attention"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, Dh), k/v (B, Hkv, Skv, Dh), all float32 or all
    bfloat16, Hq % Hkv == 0, Dh <= 256 -> (B, Hq, Sq, Dh) in q's dtype.

    Query row i sits at position Skv - Sq + i; ``window`` keeps keys
    within [pos - window + 1, pos]. ``scale`` defaults to Dh ** -0.5. A
    row with no key left (Sq > Skv under ``causal``, or a window that
    excludes every key) gives 0."""
    if _lib.on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)
    return _launch(_route(q.dtype, q.shape[-1]), q, k, v, causal=causal,
                   window=window, scale=scale)


def _launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            *, causal: bool = True, window: int | None = None,
            scale: float | None = None) -> torch.Tensor:
    """Check the CUDA tensors and launch ``kernel`` (a :func:`_route`
    name) on them. Separate from :func:`flash_attention` so that a
    measurement can time both kernels on the same bfloat16 inputs."""
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _lib.check(kernel, name, t, q.dtype, 4)
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
    if kernel == "flash_attention_tc":
        if q.dtype != torch.bfloat16 or dh not in TC_HEAD_DIMS:
            raise ValueError(f"flash_attention_tc: takes bfloat16 with head "
                             f"dim in {TC_HEAD_DIMS}, got {q.dtype}, {dh}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("flash_attention_tc: q, k and v must start on "
                             "16-byte boundaries (TMA)")
    out = torch.empty_like(q)
    if not out.numel():
        return out
    if kernel == "flash_attention_tc" and skv == 0:
        return out.zero_()   # no key row to map: every row gives 0
    s = dh ** -0.5 if scale is None else scale
    w = -1 if window is None else window
    if kernel == "flash_attention_tc":
        _lib.launch(kernel, q, k, v, out, b, hq, hkv, sq, skv, dh, s,
                    int(causal), w, device=q.device)
    else:
        _lib.launch(kernel, q, k, v, out, b, hq, hkv, sq, skv, dh, s,
                    int(causal), w, DTYPES[q.dtype], device=q.device)
    return out
