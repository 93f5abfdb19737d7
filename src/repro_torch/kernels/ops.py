"""Public entry points for the kernel ops, one per registry op.

Each function dispatches through :mod:`repro_torch.kernels.registry`:
``cuda`` (the default: the hand-written kernels, plain versions for CPU
tensors) or ``reference`` (the plain PyTorch versions on any device),
chosen per call with ``backend=``; without one, the registry's
environment variables decide per op. New code may as well resolve a
backend once (``registry.resolve``) and call its methods directly.
"""
from __future__ import annotations

from repro_torch.kernels import registry


def dense_matmul(x, w, b=None, *, activation: str = "none", backend=None):
    """act(x @ w + b); x (M, K), w (K, N)."""
    return registry.resolve(backend, op="dense_matmul").dense_matmul(
        x, w, b, activation=activation)


def graph_aggregate(blocks, h, *, index=None, backend=None):
    """Linear shard-grid aggregation: out[i] = Σ_j A[i,j] @ h[j].
    ``index``: the blocks' ``csr.linear_index``, if the caller keeps one."""
    return registry.resolve(backend, op="graph_aggregate").graph_aggregate(
        blocks, h, index=index)


def graph_aggregate_indexed(index, h, *, backend=None):
    """Linear aggregation over a ``csr.LinearIndex`` alone: row r sums
    ``val[k] · h[col[k]]`` (gat: ``val`` = attention weights)."""
    return registry.resolve(backend, op="graph_aggregate_indexed") \
        .graph_aggregate_indexed(index, h)


def fused_aggregate_extract(blocks, h, w, *, activation: str = "none",
                            index=None, backend=None):
    """act((A·H)·W) with the aggregate kept on chip. ``index``: the
    blocks' ``csr.linear_index``, if the caller keeps one."""
    return registry.resolve(backend, op="fused_aggregate_extract") \
        .fused_aggregate_extract(blocks, h, w, activation=activation,
                                 index=index)


def gather_aggregate(edge_src, edge_dst, edge_valid, h, *, op: str = "max",
                     index=None, backend=None):
    """Edge-list (gather/scatter) aggregation; max or sum. ``index``: the
    edges' ``csr.gather_index``, if the caller keeps one."""
    return registry.resolve(backend, op="gather_aggregate").gather_aggregate(
        edge_src, edge_dst, edge_valid, h, op=op, index=index)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              scale: float | None = None, backend=None):
    """Flash attention; q (B,Hq,Sq,Dh), k/v (B,Hkv,Skv,Dh)."""
    return registry.resolve(backend, op="attention").attention(
        q, k, v, causal=causal, window=window, scale=scale)
