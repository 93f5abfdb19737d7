"""The destination-sorted CSR indexes of a sharded graph.

Two formats, both plain torch on the tensors' device, built once per
graph by ``core.engines.GraphTensors`` and kept:

- :class:`GatherIndex` (:func:`gather_index`) lists each destination
  row's source rows from the padded per-shard-pair edge lists; the
  ``seg_gather`` kernel walks it.
- :class:`LinearIndex` (:func:`linear_index`) lists each destination
  row's nonzeros of the densified (S_dst, S_src, n, n) blocks, with their
  values; the ``shard_spmm`` and ``fused_gnn`` kernels walk it.

In both, global destination row r = i·n + v and global source row
j·n + u; a row's entries keep the order in which the TPU kernels visit
them (source shard j first).

Each build is counted by kind (:func:`index_builds`), as the kernel
library counts its launches: an index is the first-use work a request
pays, and the build-stability pass
(:mod:`repro_torch.analyze.op_lint`) holds a warm path to building none.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch.kernels import _lib

_lock = threading.Lock()
_builds = {"gather": 0, "linear": 0}


def _count(kind: str) -> None:
    with _lock:
        _builds[kind] += 1


def index_builds() -> dict[str, int]:
    """Index builds by kind (``gather``, ``linear``) counted since the
    last :func:`reset_index_builds`."""
    with _lock:
        return dict(_builds)


def reset_index_builds() -> None:
    with _lock:
        for k in _builds:
            _builds[k] = 0


def _row_ptr(dst: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows + 1,) int32 offsets of a sorted destination list."""
    counts = torch.bincount(dst, minlength=rows)
    row_ptr = torch.zeros(rows + 1, dtype=torch.int32, device=dst.device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return row_ptr


@dataclasses.dataclass(frozen=True)
class GatherIndex:
    """Destination-sorted edges (CSR). Global destination row r = i·n + v
    takes the global source rows ``src[row_ptr[r]:row_ptr[r + 1]]``
    (j·n + u), in (j, e) order."""

    row_ptr: torch.Tensor   # (S_dst·n + 1,) int32
    src: torch.Tensor       # (nnz,) int32


def gather_index(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 edge_valid: torch.Tensor, n: int) -> GatherIndex:
    """The :class:`GatherIndex` of (S_dst, S_src, E) padded edge lists
    with local ids in shards of ``n`` rows. Valid slots are taken in
    (i, j, e) order, ids outside [0, n) are dropped, and a stable sort by
    global destination keeps each row's edges in (j, e) order."""
    s_dst = edge_src.shape[0]
    ii, jj, ee = edge_valid.nonzero(as_tuple=True)
    u = edge_src[ii, jj, ee].long()
    v = edge_dst[ii, jj, ee].long()
    keep = (u >= 0) & (u < n) & (v >= 0) & (v < n)
    src = (jj * n + u)[keep]
    dst = (ii * n + v)[keep]
    dst, order = torch.sort(dst, stable=True)
    _count("gather")
    return GatherIndex(row_ptr=_row_ptr(dst, s_dst * n),
                       src=src[order].to(torch.int32))


# rows of more entries than this are hubs: the shard_spmm and fused_gnn
# kernels give each a block of its own instead of one warp
HUB_ENTRIES = 32


@dataclasses.dataclass(frozen=True)
class LinearIndex:
    """The nonzeros of (S_dst, S_src, n, n) blocks, sorted by destination
    (CSR). Global destination row r = i·n + v holds A[i, j, v, u] =
    ``val[k]`` at global source row ``col[k]`` = j·n + u for k in
    [row_ptr[r], row_ptr[r + 1]), in (j, u) order. ``hubs`` lists, in
    order, exactly the rows of more than ``HUB_ENTRIES`` entries."""

    row_ptr: torch.Tensor   # (S_dst·n + 1,) int32
    col: torch.Tensor       # (nnz,) int32
    val: torch.Tensor       # (nnz,) float32
    hubs: torch.Tensor      # (n_hubs,) int32


def linear_index(blocks: torch.Tensor) -> LinearIndex:
    """The :class:`LinearIndex` of ``blocks`` (S_dst, S_src, n, n): every
    nonzero, whatever the normalization or self loops that made it.
    ``nonzero`` lists them in (i, j, v, u) order; a stable sort by i·n + v
    leaves each row's entries in (j, u) order, the order of the TPU
    kernel's source shards. Reads nonzero's counts back to the host."""
    s_dst, _, n, _ = blocks.shape
    ii, jj, vv, uu = blocks.nonzero(as_tuple=True)
    val = blocks[ii, jj, vv, uu].float()
    dst, order = torch.sort(ii * n + vv, stable=True)
    row_ptr = _row_ptr(dst, s_dst * n)
    hubs = ((row_ptr[1:] - row_ptr[:-1]) > HUB_ENTRIES).nonzero()
    _count("linear")
    return LinearIndex(row_ptr=row_ptr,
                       col=(jj * n + uu)[order].to(torch.int32),
                       val=val[order].contiguous(),
                       hubs=hubs.reshape(-1).to(torch.int32))


def entry_rows(index: LinearIndex) -> torch.Tensor:
    """(nnz,) int64: the destination row of each entry of ``index``
    (``row_ptr`` expanded; no sync with the host)."""
    rows = index.row_ptr.numel() - 1
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(rows, device=counts.device), counts,
        output_size=index.col.numel())


def check_linear_index(kernel: str, index: LinearIndex, rows: int) -> None:
    """Raise unless ``index`` is one a kernel can walk for ``rows``
    destination rows: contiguous 1-d int32 ``row_ptr`` of ``rows + 1``
    offsets, int32 ``col`` and float32 ``val`` of one length, int32
    ``hubs``. (The wrapper's device check covers the index's tensors.)"""
    _lib.check(kernel, "index.row_ptr", index.row_ptr, torch.int32, 1)
    _lib.check(kernel, "index.col", index.col, torch.int32, 1)
    _lib.check(kernel, "index.val", index.val, torch.float32, 1)
    _lib.check(kernel, "index.hubs", index.hubs, torch.int32, 1)
    if index.row_ptr.numel() != rows + 1 or \
            index.col.numel() != index.val.numel():
        raise ValueError(f"{kernel}: index has {index.row_ptr.numel() - 1} "
                         f"rows and {index.col.numel()} / "
                         f"{index.val.numel()} entries; the blocks {rows} "
                         f"rows")
