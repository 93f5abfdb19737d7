"""Plain PyTorch versions of every kernel in this package.

Each function is the semantic ground truth its CUDA kernel is held to —
on the card by ``chip_smoke.py`` and the ``cuda``-marked tests, on the CPU
against the reference package's Pallas kernels in interpret mode
(tests/test_torch_kernels.py) — and what a kernel wrapper runs for CPU
tensors. Arithmetic is float32 throughout, like the reference oracles.

The edge walks (:func:`spmm_indexed`, :func:`seg_gather`,
:func:`seg_gather_indexed`) gather one source row per edge, an
(edges x D) tensor. Above ``PLAIN_BLOCK_ELEMENTS`` of it they walk the
feature columns block by block, each block under a checkpoint, so
neither the forward nor the backward holds more than a block of gathered
rows (reddit at 0.1 scale: 11.5 M edges x 602 features would be 27.6 GB
a copy). Every column is reduced alone, in the same edge order, so the
blocks give bitwise the same output as one block. Below it (and for every
Table-II graph's index) they run as one block.

The zoo's dense-adjacency layer oracles (:func:`gcn_layer`,
:func:`sage_mean_layer`, :func:`sage_max_pool_layer`, :func:`gin_layer`,
:func:`gat_layer`) follow the reference's of the same names.

One reference name needs no counterpart here: ``seg_gather_agg``, the
edge-list aggregation of ONE (dst, src) shard pair. Its ``mean`` and
``keep_identity`` modes serve only the reference's own JAX backends,
which fold partial maxima pair by pair; the port aggregates the whole
grid at once (:func:`seg_gather`, held to the reference's
``seg_gather_aggregate`` by tests/test_torch_gather_index.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

PLAIN_BLOCK_ELEMENTS = 1 << 28


def _by_columns(fn, hf: torch.Tensor, edges: int, *args) -> torch.Tensor:
    """``fn(hf[:, c0:c1], *args)`` over column blocks of at most
    ``PLAIN_BLOCK_ELEMENTS // edges`` columns, concatenated; one call if
    all columns fit, a checkpoint per block when autograd records.
    ``edges`` bounds the rows ``fn`` gathers."""
    d = hf.shape[-1]
    per = max(1, PLAIN_BLOCK_ELEMENTS // max(edges, 1))
    if per >= d:
        return fn(hf, *args)
    parts = []
    for c0 in range(0, d, per):
        hc = hf[:, c0:c0 + per]
        parts.append(checkpoint(fn, hc, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else fn(hc, *args))
    return torch.cat(parts, dim=-1)


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
    col = index.col.long()

    def walk(hc, val):
        vals = hc[col] * val[:, None]
        return torch.zeros((rows, hc.shape[-1]), device=hc.device) \
            .index_add_(0, dst, vals)

    agg = _by_columns(walk, h.reshape(-1, d).float(), col.numel(),
                      index.val)
    return agg.reshape(rows // n, n, d).to(h.dtype)


def fused_gnn_indexed(index, h: torch.Tensor, w: torch.Tensor, *,
                      activation: str = "none") -> torch.Tensor:
    """``fused_gnn`` over the blocks' linear index: act(spmm_indexed · W).
    h (S, n, D), w (D, F) -> (S, n, F). The tests' oracle for the index;
    the wrappers run :func:`fused_gnn`."""
    agg = spmm_indexed(index, h.float())
    return _activate(agg @ w.float(), activation).to(h.dtype)


def edge_entries(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 edge_valid: torch.Tensor, n: int):
    """(dst, src) global row ids (int64) of every valid slot (i, j, e) of
    (S_dst, S_src, E) edge lists with local ids in shards of ``n`` rows,
    in (i, j, e) order."""
    ii, jj, ee = edge_valid.nonzero(as_tuple=True)
    return (ii * n + edge_dst[ii, jj, ee].long(),
            jj * n + edge_src[ii, jj, ee].long())


def index_entries(index):
    """(dst, src) global row ids (int64) of a ``csr.gather_index``'s
    entries, in the index's order."""
    rows = index.row_ptr.numel() - 1
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).long()
    dst = torch.repeat_interleave(
        torch.arange(rows, device=index.src.device), counts)
    return dst, index.src.long()


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
    dst, src = edge_entries(edge_src, edge_dst, edge_valid, n)
    out = _by_columns(lambda hc: _reduce(hc[src], dst, s_dst * n, op),
                      h.reshape(-1, d).float(), src.numel())
    return out.reshape(s_dst, n, d).to(h.dtype)


def seg_gather_max_vjp(dst: torch.Tensor, src: torch.Tensor,
                       h: torch.Tensor, rows: int,
                       grad: torch.Tensor) -> torch.Tensor:
    """The gradient of ``seg_gather``'s max with respect to h (S_src, n,
    D) for edges (``dst``, ``src``: global rows, see :func:`edge_entries`)
    into ``rows`` destination rows, given the output's gradient ``grad``
    (rows, D): the reference's tie rule. The reference scatter-maxes each
    (destination shard, source shard) pair, splitting a destination's
    gradient evenly between the tied slots of one pair, then folds the
    source shards in order with ``jnp.maximum``, which gives each side ½
    at a tie. So of t source shards tied at the maximum, in shard order,
    the first gets 0.5^(t-1) and the r-th (r >= 2) 0.5^(t-r+1), each
    divided evenly among its own tied entries (a duplicate edge is two).
    A destination whose maximum is not finite gets no gradient (the
    forward gives 0 there). Column blocks as :func:`_by_columns`."""
    s_src, n, d = h.shape
    hf = h.reshape(-1, d).float()
    gf = grad.reshape(rows, d).float()
    # one key per (destination row, source shard): sorted, so a row's keys
    # are contiguous and in source-shard order (the fold order)
    keys, inv = torch.unique(dst * s_src + src // n, return_inverse=True)
    key_row = keys // s_src
    start = torch.searchsorted(key_row, key_row, right=False)
    end = torch.searchsorted(key_row, key_row, right=True) - 1
    out = torch.zeros_like(hf)
    per = max(1, PLAIN_BLOCK_ELEMENTS // max(src.numel(), 1))
    for c0 in range(0, d, per):
        vals = hf[src, c0:c0 + per]
        best = torch.full((rows, vals.shape[1]), float("-inf"),
                          device=h.device)
        best.scatter_reduce_(0, dst[:, None].expand_as(vals), vals,
                             reduce="amax", include_self=True)
        best = best[dst]
        tied = (vals == best) & torch.isfinite(best)
        n_tied = torch.zeros((keys.numel(), vals.shape[1]), dtype=torch.int64,
                             device=h.device).index_add_(0, inv, tied.long())
        has = (n_tied > 0).long()
        incl = torch.cumsum(has, dim=0)
        excl = incl - has
        before = excl - excl[start]            # tied shards before, same row
        after = incl[end] - incl               # tied shards after, same row
        weight = torch.pow(0.5, (after + (before > 0).long()).float()) \
            / n_tied.clamp(min=1)
        g = torch.where(tied, gf[dst, c0:c0 + per] * weight[inv], 0.0)
        out[:, c0:c0 + per].index_add_(0, src, g)
    return out.reshape(h.shape).to(h.dtype)


def _reduce(vals: torch.Tensor, dst: torch.Tensor, rows: int,
            op: str) -> torch.Tensor:
    """(rows, D): the max (0 where a row has no edge) or the sum of
    ``vals`` per destination row ``dst``."""
    d = vals.shape[-1]
    if op == "max":
        out = torch.full((rows, d), float("-inf"), device=vals.device)
        out.scatter_reduce_(0, dst[:, None].expand(-1, d), vals,
                            reduce="amax", include_self=True)
        return torch.where(torch.isfinite(out), out, 0.0)
    return torch.zeros((rows, d), device=vals.device).index_add_(0, dst,
                                                                 vals)


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
    dst, src = index_entries(index)
    out = _by_columns(lambda hc: _reduce(hc[src], dst, rows, op),
                      h.reshape(-1, d).float(), src.numel())
    return out.reshape(rows // n, n, d).to(h.dtype)


# --------------------------------------------------------------------------
# GNN model-zoo layer oracles. These run on FLAT (N, D) features and a
# densified (N, N) adjacency carrying the normalization the shard grid
# bakes in (gcn / mean / sum weights; masks are adj != 0): the ground
# truth each zoo forward must reproduce, with none of the runtime's
# assembly (tests/test_torch_oracles.py, chip_smoke.py phase 4i).
# --------------------------------------------------------------------------

# the max-pool and gat oracles hold (rows, N, ...) float32 temporaries:
# they take destination rows in chunks of at most this many bytes each
# (full-scale Pubmed's (N, N, 500) max-pool candidates are ~800 GB).
# Max and softmax are row-local, so any chunking gives the same result.
ORACLE_CHUNK_BYTES = 2 << 30


def _row_chunks(rows: int, row_bytes: int) -> list[tuple[int, int]]:
    per = max(1, ORACLE_CHUNK_BYTES // max(row_bytes, 1))
    return [(r0, min(rows, r0 + per)) for r0 in range(0, rows, per)]


def gcn_layer(adj: torch.Tensor, h: torch.Tensor, w: torch.Tensor, *,
              activation: str = "none") -> torch.Tensor:
    """act((Â H) W) — flat GCN layer; adj is the gcn-normalized adjacency."""
    agg = adj.float() @ h.float()
    return dense_engine(agg.to(h.dtype), w, activation=activation)


def sage_mean_layer(adj_mean: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                    *, activation: str = "none") -> torch.Tensor:
    """act(W [mean_agg(h); h]) — GraphSAGE mean aggregator (adj row-mean)."""
    agg = (adj_mean.float() @ h.float()).to(h.dtype)
    return dense_engine(torch.cat([agg, h], dim=-1), w, activation=activation)


def sage_max_pool_layer(adj_mask: torch.Tensor, h: torch.Tensor,
                        w_pool: torch.Tensor, b_pool: torch.Tensor | None,
                        w: torch.Tensor, *,
                        activation: str = "none") -> torch.Tensor:
    """GraphSAGE max-pool: z = relu(h W_p + b_p); z̄ = max_N z; act(W [z̄;h]).
    A destination with no neighbor gets z̄ = 0."""
    z = dense_engine(h, w_pool, b_pool, activation="relu").float()
    mask = adj_mask != 0
    u, d = z.shape
    zbar = torch.cat([
        torch.where(mask[r0:r1, :, None], z[None],
                    float("-inf")).amax(dim=1)
        for r0, r1 in _row_chunks(mask.shape[0], u * d * 4)])
    zbar = torch.where(torch.isfinite(zbar), zbar, 0.0).to(h.dtype)
    return dense_engine(torch.cat([zbar, h], dim=-1), w, activation=activation)


def gin_layer(adj_sum: torch.Tensor, h: torch.Tensor, eps, w1: torch.Tensor,
              b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, *,
              activation: str = "none") -> torch.Tensor:
    """GIN: MLP((1+ε) h + Σ_N h); adj_sum has NO self loops (ε handles it)."""
    agg = adj_sum.float() @ h.float()
    x = ((1.0 + eps) * h.float() + agg).to(h.dtype)
    hid = dense_engine(x, w1, b1, activation="relu")
    return dense_engine(hid, w2, b2, activation=activation)


def gat_layer(adj_mask: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
              a_src: torch.Tensor, a_dst: torch.Tensor, *,
              negative_slope: float = 0.2, activation: str = "none",
              concat_heads: bool = True) -> torch.Tensor:
    """Multi-head GAT layer.

    h: (N, D); w: (D, H*F); a_src/a_dst: (H, F); adj_mask: (N, N) nonzero
    where edge u->v exists at [v, u] (self loops included upstream).
    α_vu = softmax_u( leakyrelu(a_dst·z_v + a_src·z_u) ), out_v = Σ α z_u;
    a destination with no neighbor gets α = 0. Heads are concatenated
    (hidden layers) or averaged (output layer).
    """
    n = h.shape[0]
    heads, f = a_src.shape
    z = (h.float() @ w.float()).reshape(n, heads, f)
    s_src = torch.einsum("nhf,hf->nh", z, a_src.float())
    s_dst = torch.einsum("nhf,hf->nh", z, a_dst.float())
    parts = []
    # the largest temporary is the (rows, N, H, F) product α·z, summed
    # over the sources as a reduction: a matrix product's summation order
    # would depend on how many rows a chunk has
    for r0, r1 in _row_chunks(n, adj_mask.shape[1] * heads * f * 4):
        mask = (adj_mask[r0:r1] != 0)[:, :, None]
        logits = F.leaky_relu(s_dst[r0:r1, None, :] + s_src[None, :, :],
                              negative_slope)
        logits = torch.where(mask, logits, float("-inf"))
        m = logits.amax(dim=1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.where(mask, torch.exp(logits - m), 0.0)
        denom = e.sum(dim=1, keepdim=True)
        alpha = torch.where(denom > 0, e / denom.clamp_min(1e-30), 0.0)
        parts.append((alpha[..., None] * z[None]).sum(dim=1))
    out = torch.cat(parts)
    out = out.reshape(n, heads * f) if concat_heads else out.mean(dim=1)
    return _activate(out, activation).to(h.dtype)


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
