"""Analytical platform performance model (paper §V-§VI) — the planner's part.

Each platform is modelled from its Table-IV resource sheet: peak compute
per engine, on-chip capacity, DRAM bandwidth. The layer planner
(gnn/executor.py) scores candidate plans with these numbers. The port
keeps the paper's GNNerator platform so that its plans equal the
reference package's; a platform sheet for the card comes later.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.sharding import max_shard_nodes_for_budget


@dataclasses.dataclass(frozen=True)
class Platform:
    name: str
    dense_tflops: float          # dense/feature-extraction peak
    graph_tflops: float          # aggregation peak
    onchip_graph_mb: float       # feature scratchpad budget for shards
    dram_gbs: float
    dense_width: int = 64        # systolic width (Fig 4 utilization knee)
    dense_buffer_mb: float = 6.0 # double-buffered output scratchpad (psums)
    irregular_eff: float = 1.0   # DRAM efficiency on irregular access
    blocking: bool = True
    inter_node_parallel: bool = True   # HyGCN: False (one node at a time)


GNNERATOR = Platform("gnnerator", 8.0, 2.0, 24.0, 256.0)

CALIBRATION = {
    # Shard Compute Unit edge-record throughput (giga-edges/s): the Edge
    # Fetcher walks the shard's edge list once per dimension block — the
    # on-chip overhead the paper concedes for dimension-blocking (§IV-B).
    "edge_rate_geps": 1.0,
}


@dataclasses.dataclass(frozen=True)
class LayerWork:
    """One GNN layer on one dataset."""
    n_nodes: int
    n_edges: int
    d_agg: int        # feature dim at aggregation time
    d_in: int         # dense-engine input dim
    d_out: int        # dense-engine output dim
    dense_first: bool # GraphsagePool: dense is the producer
    extra_dense_flops: float = 0.0   # e.g. pool transform before agg


_F32 = 4


def dense_stage_time(p: Platform, w: LayerWork, block_b: int) -> float:
    flops = 2.0 * w.n_nodes * w.d_in * w.d_out + w.extra_dense_flops
    b = min(block_b, w.d_in) if p.blocking else w.d_in
    util = min(1.0, b / p.dense_width) if p.blocking else 1.0
    # activations in/out once; blocked partial sums reload only for the
    # fraction of a destination tile whose psums exceed the output buffer
    act_bytes = w.n_nodes * (w.d_in + w.d_out) * _F32
    n_tile = max_shard_nodes_for_budget(
        int(p.onchip_graph_mb * 2 ** 20), b, _F32)
    tile_out_bytes = min(n_tile, w.n_nodes) * w.d_out * _F32
    spill = max(0.0, 1.0 - p.dense_buffer_mb * 2 ** 20 / max(tile_out_bytes, 1))
    n_blocks = max(w.d_in // max(b, 1), 1)
    psum_extra = (n_blocks - 1) * 2 * w.n_nodes * w.d_out * _F32 * spill
    wt_bytes = w.d_in * w.d_out * _F32
    t_cmp = flops / (p.dense_tflops * 1e12 * util)
    t_mem = (act_bytes + psum_extra + wt_bytes) / (p.dram_gbs * 1e9)
    return max(t_cmp, t_mem)
