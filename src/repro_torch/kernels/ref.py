"""Plain PyTorch versions of every kernel in this package.

Each function is the semantic ground truth its CUDA kernel is held to —
on the card by ``chip_smoke.py`` and the ``cuda``-marked tests, on the CPU
against the reference package's Pallas kernels in interpret mode
(tests/test_torch_kernels.py) — and what a kernel wrapper runs for CPU
tensors. Arithmetic is float32 throughout, like the reference oracles.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "none":
        return x
    if activation == "relu":
        return torch.relu(x)
    if activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation; torch to erf
        return F.gelu(x, approximate="tanh")
    if activation == "silu":
        return F.silu(x)
    raise ValueError(f"unknown activation {activation}")


def dense_engine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                 *, activation: str = "none") -> torch.Tensor:
    """Dense Engine: act(x @ w + b); x (M, K), w (K, N), b (N,) or None."""
    out = x.float() @ w.float()
    if b is not None:
        out = out + b.float()
    return _activate(out, activation).to(x.dtype)


def shard_spmm(blocks: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Graph Engine linear aggregation over the shard grid.

    blocks: (S_dst, S_src, n, n), A[i, j, v, u]; h: (S_src, n, D).
    Returns (S_dst, n, D): out[i, v] = Σ_{j,u} A[i,j,v,u] · h[j,u].
    """
    return torch.einsum("ijvu,jud->ivd", blocks.float(),
                        h.float()).to(h.dtype)


def fused_gnn(blocks: torch.Tensor, h: torch.Tensor, w: torch.Tensor, *,
              activation: str = "none") -> torch.Tensor:
    """Fused aggregation + feature extraction: act((A · H) · W).

    blocks (S, S, n, n), h (S, n, D), w (D, F) -> (S, n, F).
    """
    agg = torch.einsum("ijvu,jud->ivd", blocks.float(), h.float())
    out = torch.einsum("ivd,df->ivf", agg, w.float())
    return _activate(out, activation).to(h.dtype)


def spmm_indexed(index, h: torch.Tensor) -> torch.Tensor:
    """``shard_spmm`` over the blocks' destination-sorted nonzeros
    (``csr.linear_index``: ``row_ptr``, ``col``, ``val``), walked as the
    kernels walk it: each row sums val · h[col] in entry order. h
    (S_src, n, D) -> (S_dst, n, D) with S_dst·n = len(row_ptr) - 1. The
    tests' oracle for the index; the wrappers run :func:`shard_spmm`."""
    _, n, d = h.shape
    rows = index.row_ptr.numel() - 1
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(rows, device=h.device), counts)
    vals = h.reshape(-1, d).float()[index.col.long()] * index.val[:, None]
    agg = torch.zeros((rows, d), device=h.device).index_add_(0, dst, vals)
    return agg.reshape(rows // n, n, d).to(h.dtype)


def fused_gnn_indexed(index, h: torch.Tensor, w: torch.Tensor, *,
                      activation: str = "none") -> torch.Tensor:
    """``fused_gnn`` over the blocks' linear index: act(spmm_indexed · W).
    h (S, n, D), w (D, F) -> (S, n, F). The tests' oracle for the index;
    the wrappers run :func:`fused_gnn`."""
    agg = spmm_indexed(index, h.float())
    return _activate(agg @ w.float(), activation).to(h.dtype)


def seg_gather(edge_src: torch.Tensor, edge_dst: torch.Tensor,
               edge_valid: torch.Tensor, h: torch.Tensor, *,
               op: str = "max") -> torch.Tensor:
    """Edge-list aggregation over the shard grid, vectorized.

    edge_src/edge_dst: (S_dst, S_src, E) int32 local ids, edge_valid
    (S_dst, S_src, E) bool; h: (S_src, n, D). Every valid slot (i, j, e)
    is the edge (src = j·n + edge_src, dst = i·n + edge_dst); one
    scatter-reduce over the global destination ids takes the max or sum.
    A destination with no valid in-edge gets 0.
    """
    if op not in ("max", "sum"):
        raise ValueError(f"unknown op {op}")
    s_dst = edge_src.shape[0]
    _, n, d = h.shape
    ii, jj, ee = edge_valid.nonzero(as_tuple=True)
    src = jj * n + edge_src[ii, jj, ee].long()
    dst = ii * n + edge_dst[ii, jj, ee].long()
    vals = h.reshape(-1, d).float()[src]
    if op == "max":
        out = torch.full((s_dst * n, d), float("-inf"), device=h.device)
        out.scatter_reduce_(0, dst[:, None].expand(-1, d), vals,
                            reduce="amax", include_self=True)
        out = torch.where(torch.isfinite(out), out, 0.0)
    else:
        out = torch.zeros((s_dst * n, d), device=h.device)
        out.index_add_(0, dst, vals)
    return out.reshape(s_dst, n, d).to(h.dtype)


def seg_gather_indexed(index, h: torch.Tensor, *,
                       op: str = "max") -> torch.Tensor:
    """``seg_gather`` over a destination-sorted index
    (``csr.gather_index``: ``row_ptr``, ``src`` of global rows),
    walked as the kernel walks it. h (S_src, n, D) -> (S_dst, n, D) with
    S_dst·n = len(row_ptr) - 1; a row with no edge gets 0."""
    if op not in ("max", "sum"):
        raise ValueError(f"unknown op {op}")
    _, n, d = h.shape
    rows = index.row_ptr.numel() - 1
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).long()
    dst = torch.repeat_interleave(
        torch.arange(rows, device=h.device), counts)
    vals = h.reshape(-1, d).float()[index.src.long()]
    if op == "max":
        out = torch.full((rows, d), float("-inf"), device=h.device)
        out.scatter_reduce_(0, dst[:, None].expand(-1, d), vals,
                            reduce="amax", include_self=True)
        out = torch.where(torch.isfinite(out), out, 0.0)
    else:
        out = torch.zeros((rows, d), device=h.device)
        out.index_add_(0, dst, vals)
    return out.reshape(rows // n, n, d).to(h.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    window: int | None = None) -> torch.Tensor:
    """Attention: softmax(q kᵀ · scale + mask) v, in float32.

    q (B, Hq, Sq, Dh), k/v (B, Hkv, Skv, Dh) with Hq % Hkv == 0 (GQA:
    query head h reads kv head h // (Hq / Hkv)). Query row i sits at
    position Skv - Sq + i; causal keeps keys at or before it, ``window``
    keeps keys within [pos - window + 1, pos]. A row with no key left
    gives 0. The result has q's dtype.
    """
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, sq, dh)
    s = scale if scale is not None else dh ** -0.5
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * s
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    p = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    p = torch.nan_to_num(p, nan=0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return out.reshape(b, hq, sq, dh).to(q.dtype)
