"""2-D graph sharding (paper §II-B, Fig. 1).

A graph's edge list is divided into an S×S grid of shards: shard (i, j)
holds every edge whose destination falls in node-range i and whose source
falls in node-range j, with at most ``n`` source / ``n`` destination nodes
per shard (so ≤ n² edges per shard).

Each shard's sub-adjacency is *densified* into an (n, n) block: the
reference's layout for its dense block product. The port's linear
aggregation kernels walk the blocks' nonzeros (kernels/csr.py).
The edge list per shard is also kept (padded COO) for the gather-based
aggregator (kernels/seg_gather) used for max-pool. Host-side numpy; the
arrays are bitwise equal to ``repro.core.sharding.shard_graph``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from repro_torch.utils import cdiv

Aggregator = Literal["sum", "mean", "gcn", "max"]


@dataclasses.dataclass
class ShardedGraph:
    """A graph partitioned into an S×S shard grid with node-range size n."""

    num_nodes: int          # true number of nodes N (before padding)
    n: int                  # nodes per shard range (paper's n)
    S: int                  # grid width/height: ceil(N / n)
    # Dense per-shard adjacency blocks, shape (S, S, n, n), A[i, j, v, u] is
    # the edge weight of (src=j*n+u -> dst=i*n+v). Zero where no edge.
    blocks: np.ndarray
    # Padded per-shard COO edge lists for the gather path.
    # edge_src/edge_dst: (S, S, E_max) int32, local indices in [0, n);
    # edge_valid: (S, S, E_max) bool.
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_valid: np.ndarray
    num_edges: int          # true number of edges (incl. self loops if added)
    degrees: np.ndarray     # (N_padded,) in-degree used for normalization

    @property
    def n_padded(self) -> int:
        return self.S * self.n

    @property
    def occupancy(self) -> np.ndarray:
        """(S, S) edge count per shard."""
        return self.edge_valid.sum(axis=-1)

    @property
    def density(self) -> float:
        """Fraction of occupied-shard block entries that are real edges."""
        occ = self.occupancy
        nz = (occ > 0).sum()
        if nz == 0:
            return 0.0
        return float(occ.sum()) / (nz * self.n * self.n)


def shard_graph(
    edges: np.ndarray,
    num_nodes: int,
    n: int,
    *,
    add_self_loops: bool = True,
    normalize: Aggregator = "gcn",
) -> ShardedGraph:
    """Shard an edge list into the 2-D grid of the paper.

    Args:
      edges: (E, 2) int array of (src, dst) pairs.
      num_nodes: N.
      n: max source/destination nodes per shard (paper's tunable n).
      add_self_loops: include u->u edges (GCN/Graphsage aggregate over
        N(u) ∪ {u}).
      normalize: edge-weight normalization baked into the dense blocks:
        'sum'  -> 1.0
        'mean' -> 1/deg(dst)  (Graphsage mean aggregator)
        'gcn'  -> 1/sqrt(deg(src) deg(dst))  (Kipf & Welling)
        'max'  -> 1.0 (blocks unused; max uses the gather path)
    """
    edges = np.asarray(edges, dtype=np.int64)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError(f"edges must be (E, 2), got {edges.shape}")
    if add_self_loops:
        loops = np.stack([np.arange(num_nodes)] * 2, axis=1)
        edges = np.concatenate([edges, loops], axis=0)
    src, dst = edges[:, 0], edges[:, 1]

    S = cdiv(num_nodes, n)
    n_padded = S * n

    deg = np.zeros(n_padded, dtype=np.float64)
    np.add.at(deg, dst, 1.0)
    deg_src = np.zeros(n_padded, dtype=np.float64)
    np.add.at(deg_src, src, 1.0)

    if normalize == "gcn":
        w = 1.0 / np.sqrt(np.maximum(deg_src[src], 1.0) * np.maximum(deg[dst], 1.0))
    elif normalize == "mean":
        w = 1.0 / np.maximum(deg[dst], 1.0)
    else:  # sum / max
        w = np.ones_like(src, dtype=np.float64)

    # Shard coordinates and local indices.
    si, sj = dst // n, src // n            # shard row (dst), shard col (src)
    lv, lu = dst % n, src % n              # local dst, local src

    blocks = np.zeros((S, S, n, n), dtype=np.float32)
    # accumulate duplicates (multigraph-safe)
    np.add.at(blocks, (si, sj, lv, lu), w.astype(np.float32))

    # COO per shard, padded to the max occupancy (>=1 to keep shapes sane).
    counts = np.zeros((S, S), dtype=np.int64)
    np.add.at(counts, (si, sj), 1)
    e_max = max(int(counts.max()), 1)
    edge_src = np.zeros((S, S, e_max), dtype=np.int32)
    edge_dst = np.zeros((S, S, e_max), dtype=np.int32)
    edge_valid = np.zeros((S, S, e_max), dtype=bool)
    order = np.lexsort((sj, si))
    flat = si[order] * S + sj[order]
    # position of each edge within its shard
    pos = np.zeros_like(flat)
    if len(flat):
        new_shard = np.concatenate([[True], flat[1:] != flat[:-1]])
        idx_in_run = np.arange(len(flat))
        run_start = np.maximum.accumulate(np.where(new_shard, idx_in_run, 0))
        pos = idx_in_run - run_start
    edge_src[si[order], sj[order], pos] = lu[order]
    edge_dst[si[order], sj[order], pos] = lv[order]
    edge_valid[si[order], sj[order], pos] = True

    return ShardedGraph(
        num_nodes=num_nodes,
        n=n,
        S=S,
        blocks=blocks,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_valid=edge_valid,
        num_edges=int(edges.shape[0]),
        degrees=deg,
    )


def max_shard_nodes_for_budget(
    onchip_bytes: int, feature_block: int, dtype_bytes: int = 4, dual_buffer: bool = True
) -> int:
    """How many nodes n fit on-chip given a feature block of B dims.

    Paper §IV-B: dimension-blocking keeps only B of D dims resident, so
    n grows by ~D/B, shrinking the shard-grid S and the Table-I costs.
    We need source features (n×B), destination accumulators (n×B) and the
    adjacency block (n×n); double-buffering halves the budget.
    """
    budget = onchip_bytes // (2 if dual_buffer else 1)
    # n*B*dtype*2 + n*n*dtype <= budget  -> solve quadratic in n
    a = dtype_bytes
    b = 2 * feature_block * dtype_bytes
    disc = b * b + 4 * a * budget
    n = int((-b + disc ** 0.5) / (2 * a))
    return max(n, 1)
