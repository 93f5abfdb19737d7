"""Graph Engine linear aggregation: ``out[i] = Σ_j A[i, j] @ h[j]``.

The port of ``repro.kernels.shard_spmm.shard_spmm``. The blocks'
nonzeros are first listed by destination row (``csr.linear_index``,
plain torch on the tensors' device, built once per graph by
``core.engines.GraphTensors``); the CUDA kernel ``csrc/shard_spmm.cu``
then gathers each destination row's weighted source rows into registers
and writes the row once (its header says what bounds it). The index's
hub rows get a block each. CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, csr, ref
from repro_torch.kernels.csr import LinearIndex, linear_index


def shard_spmm(blocks: torch.Tensor, h: torch.Tensor, *,
               index: LinearIndex | None = None) -> torch.Tensor:
    """blocks (S_dst, S_src, n, n) float32, h (S_src, n, D) float32 ->
    (S_dst, n, D). Rectangular grids (S_dst != S_src) are allowed.

    ``index``: the blocks' :func:`~repro_torch.kernels.csr.linear_index`,
    if the caller keeps one; without it the index is built here (a sync
    with the host). The result is the same. The kernel reads only the
    blocks' nonzeros, so it equals the full product only for finite
    ``h``: where ``h`` holds Inf or NaN behind a zero of the blocks, the
    plain version gives NaN and the kernel does not."""
    extra = () if index is None else (index.row_ptr, index.col, index.val,
                                      index.hubs)
    if _lib.on_cpu(blocks, h, *extra):
        return ref.shard_spmm(blocks, h)
    _lib.check("shard_spmm", "blocks", blocks, torch.float32, 4)
    _lib.check("shard_spmm", "h", h, torch.float32, 3)
    s_dst, s_src, n, n2 = blocks.shape
    s3, n3, d = h.shape
    if s_src != s3 or not n == n2 == n3:
        raise ValueError(f"shard_spmm: blocks {tuple(blocks.shape)} do not "
                         f"match h {tuple(h.shape)}")
    if index is None:
        index = linear_index(blocks)
    csr.check_linear_index("shard_spmm", index, s_dst * n)
    out = torch.empty((s_dst, n, d), dtype=torch.float32, device=h.device)
    if out.numel():
        _lib.launch("shard_spmm", index.row_ptr, index.col, index.val,
                    index.hubs, h, out, s_dst * n, s_src * n, d,
                    index.col.numel(), index.hubs.numel(), csr.HUB_ENTRIES,
                    device=h.device)
    return out
