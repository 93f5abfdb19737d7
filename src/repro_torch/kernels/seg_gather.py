"""Graph Engine gather/scatter aggregation (max or sum) over edge lists.

The port of ``repro.kernels.seg_gather.seg_gather_aggregate``; the CUDA
kernel is ``csrc/seg_gather.cu``: one warp per (destination shard,
32 feature columns), walking the edge slots in order without atomics, so
its result is deterministic. CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

_COLS = 32                     # feature columns per block (csrc GD)
_MAX_SMEM = 232_448            # bytes of shared memory a block may use


def seg_gather_aggregate(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                         edge_valid: torch.Tensor, h: torch.Tensor, *,
                         op: str = "max") -> torch.Tensor:
    """edge_src/edge_dst (S_dst, S_src, E) int32 local ids, edge_valid
    (S_dst, S_src, E) bool, h (S_src, n, D) float32 -> (S_dst, n, D)."""
    if op not in ("max", "sum"):
        raise ValueError(f"unknown op {op}")
    if _lib.on_cpu(edge_src, edge_dst, edge_valid, h):
        return ref.seg_gather(edge_src, edge_dst, edge_valid, h, op=op)
    _lib.check("seg_gather", "edge_src", edge_src, torch.int32, 3)
    _lib.check("seg_gather", "edge_dst", edge_dst, torch.int32, 3)
    _lib.check("seg_gather", "edge_valid", edge_valid, torch.bool, 3)
    _lib.check("seg_gather", "h", h, torch.float32, 3)
    s_dst, s_src, e = edge_src.shape
    s3, n, d = h.shape
    if edge_dst.shape != edge_src.shape or edge_valid.shape != edge_src.shape \
            or s_src != s3:
        raise ValueError(f"seg_gather: edges {tuple(edge_src.shape)} do not "
                         f"match h {tuple(h.shape)}")
    if n * _COLS * 4 > _MAX_SMEM:
        raise ValueError(f"seg_gather: n={n} needs {n * _COLS * 4} bytes of "
                         f"shared memory, above {_MAX_SMEM}")
    out = torch.empty((s_dst, n, d), dtype=torch.float32, device=h.device)
    if out.numel():
        _lib.launch("seg_gather", edge_src, edge_dst, edge_valid, h, out,
                    s_dst, s_src, n, e, d, int(op == "max"),
                    device=h.device)
    return out
