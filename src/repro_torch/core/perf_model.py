"""Analytical platform performance model (paper §V-§VI).

Each platform is modelled from its Table-IV resource sheet — peak
compute per engine, on-chip capacity, DRAM bandwidth — and driven with
the dataflow accounting of core/dataflow.py (Table-I shard traffic and
dimension-blocked schedules). The layer planner (gnn/executor.py) scores
candidate plans with these numbers, and :func:`speedup_table` gives the
paper's Fig 3 / Table V speedups. Every function here is arithmetic-for-
arithmetic the reference package's, so plans and model times agree
bitwise with ``repro.core.perf_model``.

Platform semantics:
  * gnnerator      — dual engine, flexible producer/consumer, dimension-
                     blocking (B = dense-engine width by default).
  * gnnerator_noblock — same hardware, conventional dataflow (B = D).
  * hygcn          — dual engine but: no blocking, aggregation must be
                     the producer, and aggregation processes one node at
                     a time.
  * gpu (2080 Ti)  — single compute pool; irregular aggregation runs at a
                     fraction of DRAM bandwidth (fine-grained gathers).

These are the paper's platforms; none of them is the H100 the port runs
on, whose times are measured (``repro_torch.tune``), not modelled.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

from repro_torch.core.dataflow import Dataflow, simulate_traffic
from repro_torch.core.sharding import max_shard_nodes_for_budget

if TYPE_CHECKING:
    from repro_torch.graphs.datasets import GraphProfile

# --------------------------------------------------------------------------
# Platforms (paper Table IV) + calibration constants
# --------------------------------------------------------------------------

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
GNNERATOR_NOBLOCK = dataclasses.replace(GNNERATOR, name="gnnerator_noblock",
                                        blocking=False)
HYGCN = Platform("hygcn", 8.0, 1.0, 24.0, 256.0, blocking=False,
                 inter_node_parallel=False)
GPU_2080TI = Platform("gpu", 13.0, 13.0, 5.5, 616.0, dense_width=1,
                      irregular_eff=0.26, blocking=False)

CALIBRATION = {
    # GPU: effective DRAM fraction for fine-grained feature gathers. DGL
    # scatter/gather kernels reach ~15-25% of peak bandwidth on 2080Ti-class
    # parts for <256B random accesses; 0.26 fits the measured averages (grid-searched; see EXPERIMENTS.md).
    "gpu_irregular_eff": 0.26,
    # GPU kernel-launch + framework overhead per layer stage (DGL/PyTorch):
    "gpu_launch_us": 60.0,
    # HyGCN aggregates a single node's full feature at a time (no
    # inter-node parallelism): fine-grained per-node fetches cut the
    # effective aggregation bandwidth AND compute utilization roughly in
    # half vs GNNerator's multi-GPE shard processing (HyGCN paper reports
    # ~50-60% aggregation-engine utilization on these datasets).
    "hygcn_node_serial_eff": 0.4,
    # Shard Compute Unit edge-record throughput (giga-edges/s): the Edge
    # Fetcher walks the shard's edge list once per dimension block — the
    # on-chip overhead the paper concedes for dimension-blocking (§IV-B).
    "edge_rate_geps": 1.0,
}


# --------------------------------------------------------------------------
# Workloads (paper Tables II & III)
# --------------------------------------------------------------------------

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


def network_layers(network: str, prof: GraphProfile,
                   hidden: int = 16, depth: int = 1) -> list[LayerWork]:
    """depth = number of hidden layers (paper Table III: 1); the Fig 5
    scaling study uses deeper stacks with hidden→hidden layers."""
    n, e, f = prof.num_nodes, prof.num_edges, prof.feature_dim
    c = prof.num_classes
    mid = [LayerWork(n, e, hidden, hidden, hidden, False)] * (depth - 1)
    if network == "gcn":
        return [LayerWork(n, e, f, f, hidden, False), *mid,
                LayerWork(n, e, hidden, hidden, c, False)]
    if network == "graphsage":  # concat(agg, h) -> W
        return [LayerWork(n, e, f, 2 * f, hidden, False), *mid,
                LayerWork(n, e, hidden, 2 * hidden, c, False)]
    if network == "graphsage_pool":  # W_pool h -> max-agg -> W [z̄;h]
        return [LayerWork(n, e, f, 2 * f, hidden, True,
                          extra_dense_flops=2.0 * n * f * f), *mid,
                LayerWork(n, e, hidden, 2 * hidden, c, True,
                          extra_dense_flops=2.0 * n * hidden * hidden)]
    raise ValueError(network)


# --------------------------------------------------------------------------
# Stage time models
# --------------------------------------------------------------------------

_F32 = 4


def graph_stage_time(p: Platform, w: LayerWork, block_b: int,
                 sparsity_elim: float = 1.0) -> tuple[float, int]:
    """Aggregation time (s): max(compute, off-chip shard traffic).

    sparsity_elim scales the graph-stage work down (HyGCN's window-sliding
    zero elimination — applies to aggregation only, paper §VI-A).
    """
    d = w.d_agg
    b = min(block_b, d) if p.blocking else d
    n_onchip = max_shard_nodes_for_budget(
        int(p.onchip_graph_mb * 2 ** 20), b, _F32)
    s = max(1, -(-w.n_nodes // n_onchip))
    df = Dataflow(S=s, D=d, B=b)
    tr = simulate_traffic(df, nodes_per_shard=n_onchip,
                          edges_per_shard=w.n_edges / (s * s), dtype_bytes=_F32)
    flops = 2.0 * w.n_edges * d          # multiply-accumulate per edge-dim
    serial = 1.0 if p.inter_node_parallel else \
        CALIBRATION["hygcn_node_serial_eff"]
    t_mem = tr.offchip_bytes / (p.dram_gbs * 1e9 * p.irregular_eff * serial)
    t_cmp = flops / (p.graph_tflops * 1e12 * serial)
    # edge-list re-walk once per dimension block (blocking's on-chip cost)
    t_edge = tr.onchip_edge_reads / (CALIBRATION["edge_rate_geps"] * 1e9 * serial) \
        if p.name != "gpu" else 0.0
    return max(t_cmp, t_mem, t_edge) / sparsity_elim, df.num_blocks


def dense_stage_time(p: Platform, w: LayerWork, block_b: int) -> float:
    flops = 2.0 * w.n_nodes * w.d_in * w.d_out + w.extra_dense_flops
    b = min(block_b, w.d_in) if p.blocking else w.d_in
    util = min(1.0, b / p.dense_width) if p.blocking else 1.0
    # activations in/out once; blocked partial sums reload only for the
    # fraction of a destination tile whose psums exceed the output buffer
    # (paper §IV-B: reloads are "mitigated by the increased reuse").
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


def layer_time(p: Platform, w: LayerWork, block_b: int = 64,
               sparsity_elim: float = 1.0) -> float:
    t_graph, n_blocks = graph_stage_time(p, w, block_b, sparsity_elim)
    t_dense = dense_stage_time(p, w, block_b)
    if p.name == "gpu":
        # single compute pool, stages serialized + launch overhead
        return t_graph + t_dense + 2 * CALIBRATION["gpu_launch_us"] * 1e-6
    if w.dense_first and not p.blocking and p.name == "hygcn":
        # HyGCN cannot run the Dense Engine as producer: the pool transform
        # serializes through DRAM before aggregation can start.
        return t_graph + t_dense
    overlap_grain = n_blocks if p.blocking else 2
    return max(t_graph, t_dense) + min(t_graph, t_dense) / max(overlap_grain, 1)


def model_time(p: Platform, network: str, dataset: str, *,
               block_b: int = 64, hidden: int = 16, depth: int = 1,
               sparsity_elim: float = 1.0) -> float:
    # imported here: the graphs package imports the planner, which
    # imports this module
    from repro_torch.graphs.datasets import DATASETS
    prof = DATASETS[dataset]
    return sum(layer_time(p, w, block_b, sparsity_elim)
               for w in network_layers(network, prof, hidden, depth))


def speedup_table(block_b: int = 64) -> dict:
    """Fig 3 + Table V reproduction: speedups vs the GPU baseline."""
    from repro_torch.graphs.datasets import TABLE2_DATASETS
    out: dict = {}
    for net in ("gcn", "graphsage", "graphsage_pool"):
        for ds in TABLE2_DATASETS:
            t_gpu = model_time(GPU_2080TI, net, ds)
            row = {
                "gpu_ms": t_gpu * 1e3,
                "gnnerator": t_gpu / model_time(GNNERATOR, net, ds,
                                                block_b=block_b),
                "gnnerator_noblock": t_gpu / model_time(GNNERATOR_NOBLOCK,
                                                        net, ds),
                "hygcn": t_gpu / model_time(HYGCN, net, ds),
            }
            out[f"{net}/{ds}"] = row
    return out
