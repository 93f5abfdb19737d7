"""Layer execution planner for the model zoo.

For every layer of a :class:`repro_torch.gnn.models.ZooSpec` the planner
picks

  * B      — the feature block size (paper §IV-B dimension blocking),
  * n, S   — shard size / grid width that fit the on-chip budget at B,
  * order  — src- vs dst-stationary traversal (Table I),
  * fused  — fused aggregate+extract kernel vs two-stage through memory,

by minimizing the estimated layer time under the Table-I accounting
(core/dataflow.py traffic simulation + core/perf_model.py stage times).
The arithmetic is the reference package's, so ``plan_model(...).to_json()``
equals ``repro.gnn.executor.plan_model(...).to_json()``, and
:func:`plan_key` is hex-equal to the reference's for the same inputs: a
plan file written by either package's ``REPRO_PLAN_CACHE`` memo serves
the other (an analytic plan is a pure function of its inputs).

On the card (n, B) are layout, not kernel tiles: n sets the shard grid
the graph is built with, ``fused`` picks the fused kernel, and B only
shapes the estimate — the CUDA kernels choose their own tiles.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib

from repro_torch.core.dataflow import (Dataflow, Order, Traffic, best_order,
                                       simulate_traffic)
from repro_torch.core.perf_model import (CALIBRATION, GNNERATOR, LayerWork,
                                         Platform, dense_stage_time)
from repro_torch.core.sharding import max_shard_nodes_for_budget
from repro_torch.gnn.models import ZooSpec
from repro_torch.utils import cdiv

_F32 = 4
_BLOCK_CANDIDATES = (8, 16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    layer: int
    d_agg: int              # feature dim live at aggregation time
    B: int                  # chosen feature block (B == d_agg: conventional)
    n: int                  # nodes per shard fitting the budget at B
    S: int                  # shard grid width = ceil(N / n)
    order: Order
    fused: bool
    est_graph_s: float
    est_dense_s: float
    est_layer_s: float
    est_offchip_bytes: float

    def onchip_bytes_used(self, dtype_bytes: int = _F32) -> int:
        """Working set: src block + dst accumulators + adjacency block."""
        return (2 * self.n * self.B + self.n * self.n) * dtype_bytes

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "LayerPlan":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    arch: str
    num_nodes: int
    num_edges: int
    onchip_bytes: int
    platform: str
    layers: tuple[LayerPlan, ...]

    @property
    def shard_n(self) -> int:
        """Single shard size to build GraphTensors with: the tightest
        layer's n, quantized down to a power of two so same-signature
        models share one graph build. Single-shard graphs stay exact."""
        n = min(p.n for p in self.layers)
        if n >= self.num_nodes:
            return n
        return 1 << (n.bit_length() - 1)

    @property
    def total_est_s(self) -> float:
        return sum(p.est_layer_s for p in self.layers)

    def summary(self) -> str:
        rows = [f"{self.arch}: N={self.num_nodes} E={self.num_edges} "
                f"shard_n={self.shard_n} est={self.total_est_s * 1e3:.3f}ms"]
        for p in self.layers:
            rows.append(
                f"  L{p.layer}: D={p.d_agg} B={p.B} S={p.S} n={p.n} "
                f"{p.order} {'fused' if p.fused else 'two-stage'} "
                f"({p.est_layer_s * 1e6:.1f}us, "
                f"{p.est_offchip_bytes / 2**20:.2f}MiB off-chip)")
        return "\n".join(rows)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["layers"] = [p.to_json() for p in self.layers]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ModelPlan":
        d = dict(d)
        d["layers"] = tuple(LayerPlan.from_json(p) for p in d["layers"])
        return cls(**d)


def _layer_work(spec: ZooSpec, layer: int, num_nodes: int,
                num_edges: int) -> LayerWork:
    """Map a zoo layer onto the perf model's LayerWork accounting."""
    din, dout = spec.layer_dims[layer]
    d_agg = spec.agg_dim(layer)
    if spec.arch == "gcn":
        return LayerWork(num_nodes, num_edges, d_agg, din, dout, False)
    if spec.arch == "sage_mean":
        return LayerWork(num_nodes, num_edges, d_agg, 2 * din, dout, False)
    if spec.arch == "sage_max":   # pool transform runs before aggregation
        return LayerWork(num_nodes, num_edges, d_agg, 2 * din, dout, True,
                         extra_dense_flops=2.0 * num_nodes * din * din)
    if spec.arch == "gin":        # second MLP matmul rides the dense stage
        return LayerWork(num_nodes, num_edges, d_agg, din, dout, False,
                         extra_dense_flops=2.0 * num_nodes * dout * dout)
    if spec.arch == "gat":        # z = hW before aggregation
        return LayerWork(num_nodes, num_edges, d_agg, din, dout, True,
                         extra_dense_flops=2.0 * num_edges * d_agg)
    raise ValueError(spec.arch)


def _graph_time(p: Platform, work: LayerWork, traffic: Traffic) -> float:
    """Aggregation stage time under the simulated schedule."""
    flops = 2.0 * work.n_edges * work.d_agg
    t_mem = traffic.offchip_bytes / (p.dram_gbs * 1e9 * p.irregular_eff)
    t_cmp = flops / (p.graph_tflops * 1e12)
    t_edge = traffic.onchip_edge_reads / (CALIBRATION["edge_rate_geps"] * 1e9)
    return max(t_cmp, t_mem, t_edge)


def enumerate_layer_plans(spec: ZooSpec, layer: int, num_nodes: int,
                          num_edges: int, *,
                          platform: Platform = GNNERATOR, max_n: int = 1024,
                          block_candidates: tuple[int, ...] = _BLOCK_CANDIDATES,
                          orders: tuple[Order, ...] | None = None,
                          ) -> list[LayerPlan]:
    """Every (B, n, S, order, fused) candidate for one layer, ranked by
    the Table-I analytic estimate (ascending ``est_layer_s``).

    :func:`plan_layer` takes rank 0; the autotuner (:mod:`repro_torch.tune`)
    measures the top-k on the card instead of trusting the estimate.
    ``orders`` widens the search beyond the analytically best traversal
    (the tuner passes both)."""
    work = _layer_work(spec, layer, num_nodes, num_edges)
    d = work.d_agg
    budget = int(platform.onchip_graph_mb * 2 ** 20)
    fusable = spec.arch == "gcn"           # linear agg, graph-first, no bias

    cands = sorted({b for b in block_candidates if b < d} | {d})
    out: list[LayerPlan] = []
    for b in cands:
        n = min(max_shard_nodes_for_budget(budget, b, _F32), max_n, num_nodes)
        s = cdiv(num_nodes, n)
        for order in (orders if orders is not None else (best_order(s),)):
            df = Dataflow(S=s, D=d, B=b, order=order)
            traffic = simulate_traffic(df, nodes_per_shard=n,
                                       edges_per_shard=num_edges / (s * s),
                                       dtype_bytes=_F32)
            tg = _graph_time(platform, work, traffic)
            td = dense_stage_time(platform, work, b)
            # fused: fine-grain pipeline at dimension-block granularity
            t_fused = max(tg, td) + min(tg, td) / max(df.num_blocks, 1)
            # two-stage: coarse overlap + the intermediate's memory round
            # trip
            t_mid = 2.0 * num_nodes * d * _F32 / (platform.dram_gbs * 1e9)
            t_two = max(tg, td) + min(tg, td) / 2 + t_mid
            for fused, t in (((True, t_fused),) if fusable else ()) + \
                            ((False, t_two),):
                out.append(LayerPlan(
                    layer=layer, d_agg=d, B=b, n=n, S=s, order=order,
                    fused=fused, est_graph_s=tg, est_dense_s=td,
                    est_layer_s=t,
                    est_offchip_bytes=traffic.offchip_bytes))
    out.sort(key=lambda p: p.est_layer_s)
    return out


def plan_layer(spec: ZooSpec, layer: int, num_nodes: int, num_edges: int, *,
               platform: Platform = GNNERATOR, max_n: int = 1024,
               block_candidates: tuple[int, ...] = _BLOCK_CANDIDATES,
               ) -> LayerPlan:
    """The candidate with the least estimate."""
    return enumerate_layer_plans(
        spec, layer, num_nodes, num_edges, platform=platform, max_n=max_n,
        block_candidates=block_candidates)[0]


# --------------------------------------------------------------------------
# Model planning, content-hash memoized: in-process through _PLAN_CACHE,
# across processes through JSON files in REPRO_PLAN_CACHE (or an explicit
# cache_dir). The key is a sha256 over exactly the inputs of the plan.
# --------------------------------------------------------------------------

_PLAN_CACHE: dict[str, ModelPlan] = {}
_PLAN_CACHE_STATS = {"hits": 0, "misses": 0, "disk_hits": 0}


def plan_key(spec: ZooSpec, num_nodes: int, num_edges: int, *,
             platform: Platform, max_n: int,
             block_candidates: tuple[int, ...],
             scope: dict | None = None) -> str:
    """Content hash of every input that shapes the plan.

    ``scope`` folds more key material into the hash. Analytic plans are
    a pure function of (spec, graph size, platform, knobs) and leave it
    ``None``; a measured plan is valid only where it was timed, so the
    autotuner's winner store (:mod:`repro_torch.tune.store`) passes its
    scope (plan source, backend, device, torch and CUDA versions, tuner
    version, search knobs)."""
    payload = json.dumps({
        "spec": dataclasses.asdict(spec),
        "num_nodes": num_nodes, "num_edges": num_edges,
        "platform": dataclasses.asdict(platform),
        "max_n": max_n, "block_candidates": list(block_candidates),
        **({"scope": scope} if scope else {}),
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()


def plan_cache_stats() -> dict:
    return dict(_PLAN_CACHE_STATS)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()
    for k in _PLAN_CACHE_STATS:
        _PLAN_CACHE_STATS[k] = 0


def plan_model(spec: ZooSpec, num_nodes: int, num_edges: int, *,
               platform: Platform = GNNERATOR, max_n: int = 1024,
               block_candidates: tuple[int, ...] = _BLOCK_CANDIDATES,
               cache_dir: str | os.PathLike | None = None,
               scope: dict | None = None,
               ) -> ModelPlan:
    """Plan every layer of a zoo model for one graph size (memoized; the
    plan is frozen, so every caller may share it).

    ``cache_dir`` (default: the ``REPRO_PLAN_CACHE`` environment
    variable, if set) also persists plans as JSON, so a fresh process
    reuses them. ``scope`` re-keys the memo (see :func:`plan_key`).
    """
    key = plan_key(spec, num_nodes, num_edges, platform=platform,
                   max_n=max_n, block_candidates=block_candidates,
                   scope=scope)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        _PLAN_CACHE_STATS["hits"] += 1
        return cached

    if cache_dir is None:
        cache_dir = os.environ.get("REPRO_PLAN_CACHE") or None
    disk = pathlib.Path(cache_dir) / f"{key}.json" if cache_dir else None
    if disk is not None and disk.exists():
        plan = ModelPlan.from_json(json.loads(disk.read_text()))
        _PLAN_CACHE_STATS["disk_hits"] += 1
        _PLAN_CACHE[key] = plan
        return plan

    _PLAN_CACHE_STATS["misses"] += 1
    layers = tuple(
        plan_layer(spec, i, num_nodes, num_edges, platform=platform,
                   max_n=max_n, block_candidates=block_candidates)
        for i in range(len(spec.layer_dims)))
    plan = ModelPlan(arch=spec.arch, num_nodes=num_nodes,
                     num_edges=num_edges,
                     onchip_bytes=int(platform.onchip_graph_mb * 2 ** 20),
                     platform=platform.name, layers=layers)
    _PLAN_CACHE[key] = plan
    if disk is not None:
        disk.parent.mkdir(parents=True, exist_ok=True)
        disk.write_text(json.dumps(plan.to_json()) + "\n")
    return plan
