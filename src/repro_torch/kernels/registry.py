"""Kernel backends: one method per engine compute primitive.

Two backends, with the reference package's op names:

  cuda        the default: the hand-written kernels under ``csrc/``. Each
              wrapper runs its plain version only for CPU tensors; for
              CUDA tensors it launches the kernel or raises. The GNN ops
              are differentiable: see :func:`_with_plain_vjp`.
  reference   the plain PyTorch versions (:mod:`repro_torch.kernels.ref`)
              on whatever device the tensors are on.
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.dense_engine import dense_engine_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_gnn import fused_gnn_layer
from repro_torch.kernels.seg_gather import seg_gather_aggregate
from repro_torch.kernels.shard_spmm import shard_spmm, shard_spmm_indexed

DEFAULT_BACKEND = "cuda"

OP_NAMES = ("dense_matmul", "graph_aggregate", "graph_aggregate_indexed",
            "fused_aggregate_extract", "gather_aggregate", "attention")


@runtime_checkable
class KernelBackend(Protocol):
    """One implementation of every engine compute primitive."""

    name: str

    def dense_matmul(self, x, w, b=None, *, activation: str = "none"):
        """act(x @ w + b); x (M, K), w (K, N), b (N,) or None."""
        ...

    def graph_aggregate(self, blocks, h, *, index=None):
        """Linear shard-grid aggregation: out[i] = Σ_j A[i,j] @ h[j].
        ``index``: the blocks' ``csr.linear_index`` if the caller keeps
        one."""
        ...

    def graph_aggregate_indexed(self, index, h):
        """Linear aggregation over a ``csr.LinearIndex`` alone: row r
        sums ``val[k] · h[col[k]]`` (gat: ``val`` = attention weights)."""
        ...

    def fused_aggregate_extract(self, blocks, h, w, *,
                                activation: str = "none", index=None):
        """act((A·H)·W) with the aggregate kept on chip. ``index``: the
        blocks' ``csr.linear_index`` if the caller keeps one."""
        ...

    def gather_aggregate(self, edge_src, edge_dst, edge_valid, h, *,
                         op: str = "max", index=None):
        """Edge-list (gather/scatter) aggregation; max or sum. ``index``:
        the edges' ``csr.gather_index`` if the caller keeps one."""
        ...

    def attention(self, q, k, v, *, causal: bool = True,
                  window: int | None = None, scale: float | None = None):
        """Attention; q (B,Hq,Sq,Dh), k/v (B,Hkv,Skv,Dh)."""
        ...


class _PlainVJP(torch.autograd.Function):
    """Forward ``kernel(*inputs)``; backward the vector-Jacobian product
    of ``plain(*inputs)``, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad):
        wanted = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [x if x is None else x.detach().requires_grad_(w)
                  for x, w in zip(ctx.saved_tensors, wanted)]
            grads = iter(torch.autograd.grad(
                ctx.plain(*xs), [x for x, w in zip(xs, wanted) if w], grad,
                allow_unused=True))
        return (None, None, *(next(grads) if w else None for w in wanted))


def _with_plain_vjp(kernel, plain, *inputs):
    """``kernel(*inputs)``, differentiable: the port of the reference's
    ``_with_ref_vjp``. The reference has no backward kernels; its
    backward differentiates the plain oracle, recomputing the forward,
    and so does this one (``torch.autograd.grad`` of ``plain``). Only
    ``inputs`` get gradients: blocks, edge lists and indexes are closed
    over by ``kernel`` and ``plain``. With no input that needs a gradient
    the kernel is called directly, so serving pays nothing for this."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in inputs):
        return _PlainVJP.apply(kernel, plain, *inputs)
    return kernel(*inputs)


class CudaBackend:
    """The CUDA kernels (plain versions for CPU tensors).

    The GNN ops are differentiable through :func:`_with_plain_vjp`. Where
    the caller keeps the graph's CSR index, the backward walks it
    (``ref.spmm_indexed``, ``ref.fused_gnn_indexed``,
    ``ref.seg_gather_indexed``), the same function as the dense plain
    version: on the card a gather and scatter over the nonzeros instead
    of a product over the (S, S, n, n) grid."""

    name = "cuda"

    def dense_matmul(self, x, w, b=None, *, activation="none"):
        return _with_plain_vjp(
            lambda x, w, b: dense_engine_matmul(x, w, b,
                                                activation=activation),
            lambda x, w, b: ref.dense_engine(x, w, b, activation=activation),
            x, w, b)

    def graph_aggregate(self, blocks, h, *, index=None):
        if index is None:
            def plain(h):
                return ref.shard_spmm(blocks, h)
        else:
            def plain(h):
                return ref.spmm_indexed(index, h)
        return _with_plain_vjp(lambda h: shard_spmm(blocks, h, index=index),
                               plain, h)

    def graph_aggregate_indexed(self, index, h):
        # gradients for the weights (index.val) and h
        def at(val):
            return dataclasses.replace(index, val=val)

        return _with_plain_vjp(
            lambda val, h: shard_spmm_indexed(at(val), h),
            lambda val, h: ref.spmm_indexed(at(val), h), index.val, h)

    def fused_aggregate_extract(self, blocks, h, w, *, activation="none",
                                index=None):
        if index is None:
            def plain(h, w):
                return ref.fused_gnn(blocks, h, w, activation=activation)
        else:
            def plain(h, w):
                return ref.fused_gnn_indexed(index, h, w,
                                             activation=activation)
        return _with_plain_vjp(
            lambda h, w: fused_gnn_layer(blocks, h, w, activation=activation,
                                         index=index), plain, h, w)

    def gather_aggregate(self, edge_src, edge_dst, edge_valid, h, *,
                         op="max", index=None):
        # max: a destination's gradient goes to the sources at its
        # maximum, split evenly between ties (scatter_reduce's rule)
        if index is None:
            def plain(h):
                return ref.seg_gather(edge_src, edge_dst, edge_valid, h,
                                      op=op)
        else:
            def plain(h):
                return ref.seg_gather_indexed(index, h, op=op)
        return _with_plain_vjp(
            lambda h: seg_gather_aggregate(edge_src, edge_dst, edge_valid, h,
                                           op=op, index=index), plain, h)

    def attention(self, q, k, v, *, causal=True, window=None, scale=None):
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)


class ReferenceBackend:
    """The plain PyTorch versions, on any device."""

    name = "reference"

    def dense_matmul(self, x, w, b=None, *, activation="none"):
        return ref.dense_engine(x, w, b, activation=activation)

    def graph_aggregate(self, blocks, h, *, index=None):
        # the plain version of the whole function: the index is not used
        return ref.shard_spmm(blocks, h)

    def graph_aggregate_indexed(self, index, h):
        return ref.spmm_indexed(index, h)

    def fused_aggregate_extract(self, blocks, h, w, *, activation="none",
                                index=None):
        # the plain version of the whole function: the index is not used
        return ref.fused_gnn(blocks, h, w, activation=activation)

    def gather_aggregate(self, edge_src, edge_dst, edge_valid, h, *,
                         op="max", index=None):
        # the plain version of the whole function: the index is not used
        return ref.seg_gather(edge_src, edge_dst, edge_valid, h, op=op)

    def attention(self, q, k, v, *, causal=True, window=None, scale=None):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)


_REGISTRY: dict[str, KernelBackend] = {
    "cuda": CudaBackend(), "reference": ReferenceBackend()}


def list_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve(backend: str | KernelBackend | None = None) -> KernelBackend:
    """A backend object from a name, an object, or None (the default)."""
    if backend is None:
        backend = DEFAULT_BACKEND
    if not isinstance(backend, str):
        return backend
    try:
        return _REGISTRY[backend]
    except KeyError:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"available: {list_backends()}") from None
