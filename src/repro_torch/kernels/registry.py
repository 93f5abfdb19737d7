"""Kernel backends: one method per engine compute primitive.

Two backends ship, with the reference package's op names:

  cuda        the default: the hand-written kernels under ``csrc/``. Each
              wrapper runs its plain version only for CPU tensors; for
              CUDA tensors it launches the kernel or raises. Every op is
              differentiable: see :func:`_with_plain_vjp`.
  reference   the plain PyTorch versions (:mod:`repro_torch.kernels.ref`)
              on whatever device the tensors are on.

More can be added with :func:`register_backend`. Selection precedence,
most specific wins:

  1. an explicit backend passed per call / per ``runtime.compile(...)``,
  2. a per-op override in ``REPRO_KERNEL_BACKEND_<OP>`` (op upper-cased),
  3. the global ``REPRO_KERNEL_BACKEND`` environment variable,
  4. the default, ``cuda``.

``ref`` is accepted everywhere as an alias for ``reference``.

The reference's ``JaxBackend`` (jnp versions) and ``PallasBackend`` (the
Pallas kernels) need no counterpart of their names: :class:`ReferenceBackend`
and :class:`CudaBackend` are theirs.
"""
from __future__ import annotations

import dataclasses
import os
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


class _GatherMaxVJP(torch.autograd.Function):
    """Forward ``kernel(h)`` (``seg_gather``'s max); backward
    ``ref.seg_gather_max_vjp`` over the edges that ``entries()`` lists:
    the reference's rule for ties between source shards (autograd of a
    scatter-reduce would split every tie evenly)."""

    @staticmethod
    def forward(ctx, kernel, entries, rows, h):
        ctx.entries, ctx.rows = entries, rows
        ctx.save_for_backward(h)
        return kernel(h)

    @staticmethod
    def backward(ctx, grad):
        h, = ctx.saved_tensors
        dst, src = ctx.entries()
        return None, None, None, ref.seg_gather_max_vjp(dst, src, h,
                                                        ctx.rows, grad)


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


def _gather_max(kernel, edge_src, edge_dst, edge_valid, h, index):
    """``kernel(h)`` (a max over the edges, or over ``index``'s entries
    where the caller keeps it), differentiable with the reference's tie
    rule (:class:`_GatherMaxVJP`)."""
    if not (torch.is_grad_enabled() and h.requires_grad):
        return kernel(h)
    n = h.shape[1]
    if index is None:
        def entries():
            return ref.edge_entries(edge_src, edge_dst, edge_valid, n)
        rows = edge_src.shape[0] * n
    else:
        def entries():
            return ref.index_entries(index)
        rows = index.row_ptr.numel() - 1
    return _GatherMaxVJP.apply(kernel, entries, rows, h)


class CudaBackend:
    """The CUDA kernels (plain versions for CPU tensors).

    Every op is differentiable through :func:`_with_plain_vjp` (the
    gathers' max through :func:`_gather_max`); the attention's backward
    is autograd of ``ref.flash_attention`` with the same ``causal``,
    ``window`` and ``scale``. Where
    the caller keeps the graph's CSR index, the backward walks it
    (``ref.spmm_indexed``, ``ref.fused_gnn_indexed``,
    ``ref.seg_gather_indexed``; the max's backward is
    ``ref.seg_gather_max_vjp`` over the index's or the edge lists'
    entries), the same function as the dense plain
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
        def kernel(h):
            return seg_gather_aggregate(edge_src, edge_dst, edge_valid, h,
                                        op=op, index=index)

        if op == "max":
            return _gather_max(kernel, edge_src, edge_dst, edge_valid, h,
                               index)
        if index is None:
            def plain(h):
                return ref.seg_gather(edge_src, edge_dst, edge_valid, h,
                                      op=op)
        else:
            def plain(h):
                return ref.seg_gather_indexed(index, h, op=op)
        return _with_plain_vjp(kernel, plain, h)

    def attention(self, q, k, v, *, causal=True, window=None, scale=None):
        return _with_plain_vjp(
            lambda q, k, v: flash_attention(q, k, v, causal=causal,
                                            window=window, scale=scale),
            lambda q, k, v: ref.flash_attention(q, k, v, causal=causal,
                                                scale=scale, window=window),
            q, k, v)


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
        # the plain version of the whole function: the index is not used;
        # the max's backward is the reference's tie rule, as on cuda
        def plain(h):
            return ref.seg_gather(edge_src, edge_dst, edge_valid, h, op=op)

        if op == "max":
            return _gather_max(plain, edge_src, edge_dst, edge_valid, h,
                               None)
        return plain(h)

    def attention(self, q, k, v, *, causal=True, window=None, scale=None):
        return ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                   window=window)


_REGISTRY: dict[str, KernelBackend] = {}
_ALIASES: dict[str, str] = {}


def register_backend(backend: KernelBackend, *,
                     aliases: tuple[str, ...] = ()) -> KernelBackend:
    """Register a backend under ``backend.name`` (plus ``aliases``).
    Re-registering a name replaces it, so tests and plugins can swap
    implementations."""
    _REGISTRY[backend.name] = backend
    for a in aliases:
        _ALIASES[a] = backend.name
    return backend


def get_backend(name: str) -> KernelBackend:
    """The registered backend called ``name`` (or an alias of it)."""
    try:
        return _REGISTRY[_ALIASES.get(name, name)]
    except KeyError:
        raise ValueError(f"unknown kernel backend {name!r}; "
                         f"registered: {list_backends()}") from None


def list_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve(backend: str | KernelBackend | None = None, *,
            op: str | None = None) -> KernelBackend:
    """The backend for one call (see the module docstring for the
    precedence).

    ``backend`` is the explicit choice and wins: a registered name or a
    backend object (e.g. a :func:`composite_backend`). With None, the
    environment decides: ``REPRO_KERNEL_BACKEND_<OP>`` for ``op`` (a
    keyword: ``op=None`` skips the per-op variable), then
    ``REPRO_KERNEL_BACKEND``, then ``DEFAULT_BACKEND``. The reference
    package's ``resolve(op, override)`` takes the op first; here the
    first positional argument is always the backend.
    """
    if backend is not None:
        if isinstance(backend, str):
            return get_backend(backend)
        return backend
    if op is not None:
        per_op = os.environ.get(f"REPRO_KERNEL_BACKEND_{op.upper()}")
        if per_op:
            return get_backend(per_op)
    return get_backend(os.environ.get("REPRO_KERNEL_BACKEND",
                                      DEFAULT_BACKEND))


class _CompositeBackend:
    """Routes each op to its own backend (per-op selection)."""

    def __init__(self, default: KernelBackend,
                 per_op: dict[str, KernelBackend]):
        self.default = default
        self.per_op = per_op
        ops = ",".join(f"{k}={v.name}" for k, v in sorted(per_op.items()))
        self.name = f"composite({default.name}; {ops})"
        for op in OP_NAMES:
            setattr(self, op, getattr(per_op.get(op, default), op))


def composite_backend(default: str | KernelBackend,
                      per_op: dict[str, str | KernelBackend]
                      ) -> KernelBackend:
    """A backend that answers each op from its own registry entry
    (``runtime.compile(..., op_backends={...})`` builds one)."""
    for op in per_op:
        if op not in OP_NAMES:
            raise ValueError(f"unknown op {op!r}; ops: {OP_NAMES}")
    return _CompositeBackend(
        resolve(default), {op: resolve(b) for op, b in per_op.items()})


register_backend(CudaBackend())
register_backend(ReferenceBackend(), aliases=("ref",))
