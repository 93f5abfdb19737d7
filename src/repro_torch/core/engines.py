"""Dense Engine / Graph Engine abstractions (paper §III).

On the ASIC these are two physical compute engines coordinated by the
GNNerator Controller (either may be producer or consumer). Here they are
thin wrappers over a kernel backend; the Controller's role — deciding
the producer/consumer order and whether the two stages are pipelined —
becomes a kernel choice: graph-first layers with linear aggregation use
the *fused* kernel (the aggregate stays in shared memory), everything
else composes the two engine kernels through device memory, like the
ASIC's feature memory.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Literal

import numpy as np
import torch

from repro_torch.core.sharding import ShardedGraph
from repro_torch.kernels import csr
from repro_torch.kernels.registry import KernelBackend, resolve


@dataclasses.dataclass(frozen=True)
class GraphTensors:
    """Device tensors for one sharded graph + one normalization."""

    blocks: torch.Tensor      # (S, S, n, n) float32 densified adjacency
    edge_src: torch.Tensor    # (S, S, E) int32
    edge_dst: torch.Tensor    # (S, S, E) int32
    edge_valid: torch.Tensor  # (S, S, E) bool
    num_nodes: int
    n: int
    S: int

    @classmethod
    def from_sharded(cls, sg: ShardedGraph,
                     device: torch.device | str) -> "GraphTensors":
        def put(a):
            return torch.from_numpy(a).to(device)

        return cls(blocks=put(sg.blocks), edge_src=put(sg.edge_src),
                   edge_dst=put(sg.edge_dst), edge_valid=put(sg.edge_valid),
                   num_nodes=sg.num_nodes, n=sg.n, S=sg.S)

    # Both indexes are built outside inference mode, whatever the first
    # caller: a serving forward runs under torch.inference_mode(), and a
    # training step on the same graph later saves index tensors for its
    # backward, which inference tensors cannot be.

    @functools.cached_property
    def gather_index(self) -> csr.GatherIndex:
        """The edges sorted by destination (CSR), built at the first
        gather and kept: models that never gather never build it."""
        with torch.inference_mode(False):
            return csr.gather_index(self.edge_src, self.edge_dst,
                                    self.edge_valid, self.n)

    @functools.cached_property
    def linear_index(self) -> csr.LinearIndex:
        """The blocks' nonzeros sorted by destination (CSR), built at the
        first linear aggregation or fused layer and kept: models that
        only gather never build it."""
        with torch.inference_mode(False):
            return csr.linear_index(self.blocks)

    @property
    def occupancy(self) -> np.ndarray:
        """(S, S) edge count per shard pair, on the host (a sync): lets
        ``graphs/partition.py`` plan over device tensors as over a
        ``ShardedGraph``."""
        return self.edge_valid.sum(dim=-1).cpu().numpy()

    @property
    def device(self) -> torch.device:
        return self.blocks.device

    def group(self, h: torch.Tensor) -> torch.Tensor:
        """(N, D) node features -> (S, n, D) shard-grouped (zero padded)."""
        out = torch.zeros((self.S * self.n, h.shape[-1]), dtype=h.dtype,
                          device=h.device)
        out[: h.shape[0]] = h
        return out.reshape(self.S, self.n, -1)

    def ungroup(self, h: torch.Tensor) -> torch.Tensor:
        """(S, n, D) -> (N, D)."""
        return h.reshape(self.S * self.n, -1)[: self.num_nodes]


@dataclasses.dataclass(frozen=True)
class DenseEngine:
    """Feature extraction: blocked matmul + activation unit.

    ``backend`` pins a :class:`~repro_torch.kernels.registry.KernelBackend`;
    None resolves per call from the registry (environment-selectable per
    op)."""

    backend: KernelBackend | None = None

    def __call__(self, x, w, b=None, *, activation: str = "none"):
        return resolve(self.backend, op="dense_matmul").dense_matmul(
            x, w, b, activation=activation)


@dataclasses.dataclass(frozen=True)
class GraphEngine:
    """Aggregation over the shard grid. ``backend`` as
    :class:`DenseEngine`'s."""

    backend: KernelBackend | None = None

    def aggregate(self, gt: GraphTensors, h: torch.Tensor, *,
                  op: Literal["linear", "max", "sum"] = "linear"
                  ) -> torch.Tensor:
        """h: (S, n, D) shard-grouped. Linear = weights baked into blocks
        (sum/mean/gcn), walked through the graph's kept linear index;
        max/sum go through the edge-list gather kernel."""
        if op == "linear":
            return resolve(self.backend, op="graph_aggregate") \
                .graph_aggregate(gt.blocks, h, index=gt.linear_index)
        return resolve(self.backend, op="gather_aggregate").gather_aggregate(
            gt.edge_src, gt.edge_dst, gt.edge_valid, h, op=op,
            index=gt.gather_index)

    def aggregate_indexed(self, index: csr.LinearIndex,
                          h: torch.Tensor) -> torch.Tensor:
        """Linear aggregation over ``index`` alone: destination row r sums
        ``val[k] · h[col[k]]``. gat passes the graph's kept linear index
        with a head's attention weights as ``val``."""
        return resolve(self.backend, op="graph_aggregate_indexed") \
            .graph_aggregate_indexed(index, h)

    def spmm(self, blocks: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """Shard-grid SpMM on explicit (S, S, n, n) blocks; their linear
        index is built in the call."""
        return resolve(self.backend, op="graph_aggregate") \
            .graph_aggregate(blocks, h)


@dataclasses.dataclass(frozen=True)
class GNNeratorController:
    """Composes the engines per layer topology (paper §III-C).

    graph-first + linear aggregation -> fused kernel (fine-grain pipeline);
    otherwise the stages run back-to-back through feature memory.
    """

    dense: DenseEngine = DenseEngine()
    graph: GraphEngine = GraphEngine()
    fuse: bool = True

    def graph_first(self, gt: GraphTensors, h: torch.Tensor, w: torch.Tensor,
                    b=None, *, activation: str = "none") -> torch.Tensor:
        """act((A · H) · W) — GCN-style layer body on grouped features."""
        if self.fuse and b is None:
            be = resolve(self.graph.backend, op="fused_aggregate_extract")
            return be.fused_aggregate_extract(gt.blocks, h, w,
                                              activation=activation,
                                              index=gt.linear_index)
        agg = self.graph.aggregate(gt, h, op="linear")
        s, n, d = agg.shape
        out = self.dense(agg.reshape(s * n, d), w, b, activation=activation)
        return out.reshape(s, n, -1)

    def dense_first(self, gt: GraphTensors, h: torch.Tensor,
                    w_pool: torch.Tensor, b_pool=None, *,
                    activation: str = "none",
                    agg: Literal["max", "sum"] = "max") -> torch.Tensor:
        """agg(act(H · W_pool)) — GraphsagePool-style: the Dense Engine is
        the producer, the Graph Engine the consumer."""
        s, n, d = h.shape
        z = self.dense(h.reshape(s * n, d), w_pool, b_pool,
                       activation=activation)
        return self.graph.aggregate(gt, z.reshape(s, n, -1), op=agg)
