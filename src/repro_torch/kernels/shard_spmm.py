"""Graph Engine linear aggregation: ``out[i] = Σ_j A[i, j] @ h[j]``.

The port of ``repro.kernels.shard_spmm.shard_spmm``; the CUDA kernel is
``csrc/shard_spmm.cu`` (its header says what bounds it and how the TPU
grid maps onto the card). CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref


def shard_spmm(blocks: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """blocks (S_dst, S_src, n, n) float32, h (S_src, n, D) float32 ->
    (S_dst, n, D). Rectangular grids (S_dst != S_src) are allowed.

    The kernel skips (64 × 16) slices of the blocks that are all zero, so
    it equals the full product only for finite ``h``: where ``h`` holds
    Inf or NaN behind a zero slice, the plain version gives NaN and the
    kernel does not."""
    if _lib.on_cpu(blocks, h):
        return ref.shard_spmm(blocks, h)
    _lib.check("shard_spmm", "blocks", blocks, torch.float32, 4)
    _lib.check("shard_spmm", "h", h, torch.float32, 3)
    s_dst, s_src, n, n2 = blocks.shape
    s3, n3, d = h.shape
    if s_src != s3 or not n == n2 == n3:
        raise ValueError(f"shard_spmm: blocks {tuple(blocks.shape)} do not "
                         f"match h {tuple(h.shape)}")
    out = torch.empty((s_dst, n, d), dtype=torch.float32, device=h.device)
    if out.numel() and s_src:
        _lib.launch("shard_spmm", blocks, h, out, s_dst, s_src, n, d,
                    device=h.device)
    else:
        out.zero_()
    return out
