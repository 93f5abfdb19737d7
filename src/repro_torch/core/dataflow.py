"""GNN dataflows (paper §IV, Algorithm 1 + Table I).

The conventional dataflow walks the S×S shard grid with the *entire*
feature vector (B = D) resident per node. The paper's feature
dimension-blocking dataflow adds an outer loop over D/B feature blocks so
only an (n × B) slice of features is on-chip at a time, allowing larger
shards (bigger n, smaller S) for a fixed on-chip budget.

This module provides:
  * schedule generation (loop-nest iteration order, src-/dst-stationary,
    serpentine S-pattern),
  * the analytical Table-I read/write cost model and the traversal
    choice it implies,
  * a traffic simulator that walks a schedule and counts off-chip
    feature transfers and on-chip edge re-reads (the layer planner,
    gnn/executor.py, and the platform model, core/perf_model.py, read
    it),
  * the paper's §IV-B headline comparison of the blocked and
    conventional dataflows at one on-chip budget.

It is a host-side numpy copy of ``repro.core.dataflow`` and must stay
arithmetic-for-arithmetic equal to it, so plans and reports agree.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Literal

import numpy as np

from repro_torch.core.sharding import max_shard_nodes_for_budget
from repro_torch.utils import cdiv

Order = Literal["src_stationary", "dst_stationary"]


@dataclasses.dataclass(frozen=True)
class Dataflow:
    """A dimension-blocked shard-grid schedule (Algorithm 1)."""

    S: int                  # shard grid width/height
    D: int                  # feature dimension
    B: int                  # feature block size (B == D -> conventional)
    order: Order = "dst_stationary"
    serpentine: bool = True  # S-pattern: reverse inner loop on odd outer steps

    @property
    def num_blocks(self) -> int:
        return cdiv(self.D, self.B)

    def steps(self) -> Iterator[tuple[int, int, int]]:
        """Yield (dim_block, dst_shard, src_shard) in execution order."""
        for blk in range(self.num_blocks):
            for outer in range(self.S):
                inner_range = range(self.S)
                if self.serpentine and outer % 2 == 1:
                    inner_range = reversed(inner_range)  # type: ignore[assignment]
                for inner in inner_range:
                    if self.order == "dst_stationary":
                        yield blk, outer, inner
                    else:
                        yield blk, inner, outer


def table1_costs(S: int, I: float = 1.0) -> dict[str, dict[str, float]]:
    """Paper Table I, verbatim (units of shard-feature transfers)."""
    return {
        "src_stationary": {
            "read": S * I + (S - 1) * S - S + 1,
            "write": S * S - S + 1,
        },
        "dst_stationary": {
            "read": (S * S - S + 1) * I,
            "write": float(S),
        },
    }


def best_order(S: int, I: float = 1.0, read_cost: float = 1.0, write_cost: float = 1.0) -> Order:
    """Pick the cheaper traversal order per Table I (equal rd/wr cost by default)."""
    c = table1_costs(S, I)
    tot = {k: v["read"] * read_cost + v["write"] * write_cost for k, v in c.items()}
    return min(tot, key=tot.get)  # type: ignore[return-value]


@dataclasses.dataclass
class Traffic:
    """Off-chip feature bytes + on-chip edge walks for one layer's aggregation."""

    offchip_read_bytes: float
    offchip_write_bytes: float
    onchip_edge_reads: float     # edge-record reads (edge list walked D/B times)
    steps: int

    @property
    def offchip_bytes(self) -> float:
        return self.offchip_read_bytes + self.offchip_write_bytes


def simulate_traffic(
    df: Dataflow,
    *,
    nodes_per_shard: int,
    edges_per_shard: np.ndarray | float,
    dtype_bytes: int = 4,
    skip_empty: bool = True,
) -> Traffic:
    """Count off-chip transfers for a schedule (Table-I accounting).

      * SOURCE features are read whenever a source block becomes resident.
      * DESTINATION accumulators start at zero on-chip; they are written
        back on every eviction and re-read when a previously evicted
        destination becomes resident again.
      * every visited shard's edge list is walked once per dimension block.
    """
    S, B = df.S, df.B
    blk_feat_bytes = nodes_per_shard * B * dtype_bytes

    if np.isscalar(edges_per_shard):
        occ = np.full((S, S), float(edges_per_shard))
    else:
        occ = np.asarray(edges_per_shard, dtype=np.float64)

    reads = 0.0
    writes = 0.0
    edge_reads = 0.0
    steps = 0

    dst_stationary = df.order == "dst_stationary"
    resident_outer = -1
    resident_inner = -1
    touched_dst: set[tuple[int, int]] = set()
    for blk, dst, src in df.steps():
        outer, inner = (dst, src) if dst_stationary else (src, dst)
        if skip_empty and occ[dst, src] == 0:
            continue
        steps += 1
        if outer != resident_outer:
            if dst_stationary:
                if resident_outer >= 0:
                    writes += blk_feat_bytes
            else:
                reads += blk_feat_bytes
            resident_outer = outer
        if inner != resident_inner:
            if dst_stationary:
                reads += blk_feat_bytes
            else:
                if resident_inner >= 0:
                    writes += blk_feat_bytes
                if (blk, inner) in touched_dst:
                    reads += blk_feat_bytes
                touched_dst.add((blk, inner))
            resident_inner = inner
        edge_reads += occ[dst, src]
    # retire the final destination set
    if resident_outer >= 0 or resident_inner >= 0:
        writes += blk_feat_bytes
    return Traffic(
        offchip_read_bytes=reads,
        offchip_write_bytes=writes,
        onchip_edge_reads=edge_reads,
        steps=steps,
    )


def blocked_vs_conventional(
    *,
    num_nodes: int,
    D: int,
    B: int,
    onchip_bytes: int,
    dtype_bytes: int = 4,
) -> dict[str, float]:
    """Headline comparison (paper §IV-B): for a fixed on-chip budget, the
    blocked dataflow fits n_blocked = budget/(B) nodes vs n_conv =
    budget/(D) nodes, so S shrinks by ~D/B and off-chip traffic drops.

    Returns the shard counts and Table-I read totals for both dataflows.
    """
    n_conv = max_shard_nodes_for_budget(onchip_bytes, D, dtype_bytes)
    n_blk = max_shard_nodes_for_budget(onchip_bytes, B, dtype_bytes)
    S_conv = cdiv(num_nodes, n_conv)
    S_blk = cdiv(num_nodes, n_blk)
    costs_conv = table1_costs(S_conv)["dst_stationary"]
    costs_blk = table1_costs(S_blk)["dst_stationary"]
    conv_bytes = (costs_conv["read"] + costs_conv["write"]) * n_conv * D * dtype_bytes
    # the last (partial) feature block still costs a full grid sweep, so the
    # block count is ceil(D/B)
    blk_bytes = (
        (costs_blk["read"] + costs_blk["write"]) * n_blk * B * dtype_bytes * cdiv(D, max(B, 1))
    )
    return {
        "n_conventional": n_conv,
        "n_blocked": n_blk,
        "S_conventional": S_conv,
        "S_blocked": S_blk,
        "offchip_bytes_conventional": conv_bytes,
        "offchip_bytes_blocked": blk_bytes,
        "traffic_ratio": conv_bytes / max(blk_bytes, 1.0),
    }
