"""Graph Engine gather aggregation (max or sum) over edge lists.

The port of ``repro.kernels.seg_gather.seg_gather_aggregate``. The padded
per-shard-pair edge lists are first turned into a destination-sorted
index (``csr.gather_index``, plain torch on the tensors' device, built
once per graph by ``core.engines.GraphTensors``); the CUDA kernel
``csrc/seg_gather.cu`` then gives each destination row one warp that
gathers its source rows in the order the TPU kernel applies them,
without atomics, so its result is deterministic. CPU tensors take the
plain versions in ``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref
from repro_torch.kernels.csr import GatherIndex, gather_index

__all__ = ["GatherIndex", "gather_index", "seg_gather_aggregate"]


def seg_gather_aggregate(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                         edge_valid: torch.Tensor, h: torch.Tensor, *,
                         op: str = "max",
                         index: GatherIndex | None = None) -> torch.Tensor:
    """edge_src/edge_dst (S_dst, S_src, E) int32 local ids, edge_valid
    (S_dst, S_src, E) bool, h (S_src, n, D) float32 -> (S_dst, n, D).

    ``index``: the edges' :func:`gather_index`, if the caller keeps one;
    without it the index is built here. The result is the same."""
    if op not in ("max", "sum"):
        raise ValueError(f"unknown op {op}")
    extra = () if index is None else (index.row_ptr, index.src)
    if _lib.on_cpu(edge_src, edge_dst, edge_valid, h, *extra):
        if index is not None:
            return ref.seg_gather_indexed(index, h, op=op)
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
    if index is None:
        index = gather_index(edge_src, edge_dst, edge_valid, n)
    _lib.check("seg_gather", "index.row_ptr", index.row_ptr, torch.int32, 1)
    _lib.check("seg_gather", "index.src", index.src, torch.int32, 1)
    if index.row_ptr.numel() != s_dst * n + 1:
        raise ValueError(f"seg_gather: index has {index.row_ptr.numel() - 1} "
                         f"rows, the edges {s_dst * n}")
    if (d + 511) // 512 > 65535:
        raise ValueError(f"seg_gather: D = {d} exceeds the grid limit")
    out = torch.empty((s_dst, n, d), dtype=torch.float32, device=h.device)
    if out.numel():
        _lib.launch("seg_gather", index.row_ptr, index.src, h, out,
                    s_dst * n, d, int(op == "max"), index.src.numel(),
                    s_src * n, device=h.device)
    return out
