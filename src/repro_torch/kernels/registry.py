"""Kernel backends: one method per engine compute primitive.

Two backends, with the reference package's op names:

  cuda        the default: the hand-written kernels under ``csrc/``. Each
              wrapper runs its plain version only for CPU tensors; for
              CUDA tensors it launches the kernel or raises.
  reference   the plain PyTorch versions (:mod:`repro_torch.kernels.ref`)
              on whatever device the tensors are on.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.kernels import ref
from repro_torch.kernels.dense_engine import dense_engine_matmul
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_gnn import fused_gnn_layer
from repro_torch.kernels.seg_gather import seg_gather_aggregate
from repro_torch.kernels.shard_spmm import shard_spmm

DEFAULT_BACKEND = "cuda"

OP_NAMES = ("dense_matmul", "graph_aggregate", "fused_aggregate_extract",
            "gather_aggregate", "attention")


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


class CudaBackend:
    """The CUDA kernels (plain versions for CPU tensors)."""

    name = "cuda"

    def dense_matmul(self, x, w, b=None, *, activation="none"):
        return dense_engine_matmul(x, w, b, activation=activation)

    def graph_aggregate(self, blocks, h, *, index=None):
        return shard_spmm(blocks, h, index=index)

    def fused_aggregate_extract(self, blocks, h, w, *, activation="none",
                                index=None):
        return fused_gnn_layer(blocks, h, w, activation=activation,
                               index=index)

    def gather_aggregate(self, edge_src, edge_dst, edge_valid, h, *,
                         op="max", index=None):
        return seg_gather_aggregate(edge_src, edge_dst, edge_valid, h, op=op,
                                    index=index)

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
