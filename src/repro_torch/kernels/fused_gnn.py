"""Fused Graph Engine -> Dense Engine layer: ``act((A · H) · W)``.

The port of ``repro.kernels.fused_gnn.fused_gnn_layer``; the CUDA kernel
is ``csrc/fused_gnn.cu``, whose (n × 64) aggregate tiles live in shared
memory and never reach device memory. CPU tensors take the plain version
in ``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

ACTIVATIONS = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}
_MAX_SLICES = 32768            # csrc kMaxSlices: the kernel's slice bitmap


def fused_gnn_layer(blocks: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                    *, activation: str = "none") -> torch.Tensor:
    """blocks (S, S, n, n), h (S, n, D), w (D, F), all float32 ->
    (S, n, F).

    The kernel skips (64 × 16) slices of the blocks that are all zero, so
    it equals the full product only for finite ``h``: where ``h`` holds
    Inf or NaN behind a zero slice, the plain version gives NaN and the
    kernel does not."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation}")
    if _lib.on_cpu(blocks, h, w):
        return ref.fused_gnn(blocks, h, w, activation=activation)
    _lib.check("fused_gnn", "blocks", blocks, torch.float32, 4)
    _lib.check("fused_gnn", "h", h, torch.float32, 3)
    _lib.check("fused_gnn", "w", w, torch.float32, 2)
    s, s2, n, n2 = blocks.shape
    s3, n3, d = h.shape
    d2, f = w.shape
    if not (s == s2 == s3 and n == n2 == n3 and d == d2):
        raise ValueError(f"fused_gnn: shapes do not match: blocks "
                         f"{tuple(blocks.shape)}, h {tuple(h.shape)}, "
                         f"w {tuple(w.shape)}")
    if s * -(-n // 16) > _MAX_SLICES:
        raise ValueError(f"fused_gnn: a {s}x{s} grid of {n}-node shards "
                         f"has more than {_MAX_SLICES} slices per block row")
    out = torch.empty((s, n, f), dtype=torch.float32, device=h.device)
    if out.numel():
        _lib.launch("fused_gnn", blocks, h, w, out, s, n, d, f,
                    ACTIVATIONS[activation], device=h.device)
    return out
