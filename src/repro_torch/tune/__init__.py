"""repro_torch.tune — empirical plan autotuner (measured plans over Table I).

The analytic Table-I planner estimates which (shard S, feature block B,
traversal order, fused-vs-two-stage) dataflow is fastest per layer; this
package *measures* it. :func:`autotune_plan` enumerates the analytic
top-k whole-model candidates (:mod:`repro_torch.tune.search`), prunes
the illegal and the execution-identical ones, times each survivor on
the real kernel backend and device with warm-up + median-of-k and
per-candidate timeout/OOM guards (:mod:`repro_torch.tune.measure`), and
memoizes the winner through the ``REPRO_PLAN_CACHE`` disk cache under a
key that names the backend and the device
(:mod:`repro_torch.tune.store`).

The runtime entry point is::

    exe = runtime.compile(spec, graph, plan="autotune", tune_budget=8)
    print(exe.summary())   # which source/config won, and by how much

The analytic plan is always candidate #0, so the measured winner is
``>=`` the analytic choice by construction; if every measurement fails
(a broken backend, OOM on every config) the analytic plan is returned as
an explicit ``analytic_fallback`` — tuning degrades, never crashes.

On the port only shard_n and each layer's ``fused`` flag reach a kernel,
so most candidates run the same program and are pruned before they are
measured (:func:`repro_torch.analyze.plan_lint.executed_digest`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import env
from repro_torch.core.perf_model import GNNERATOR, Platform
from repro_torch.gnn.executor import _BLOCK_CANDIDATES, plan_model
from repro_torch.gnn.models import ZooSpec, init_params, params_from_numpy
from repro_torch.kernels.registry import KernelBackend
from repro_torch.tune.measure import Measurement, measure_plan
from repro_torch.tune.search import candidate_plans, layer_config, plan_digest
from repro_torch.tune.store import (TUNER_VERSION, TuneRecord,
                                    clear_tune_cache, count_measurements,
                                    load_record, save_record,
                                    tune_cache_stats, tune_key, tune_scope)

__all__ = [
    "autotune_plan", "candidate_plans", "measure_plan",
    "Measurement", "TuneRecord", "TUNER_VERSION",
    "tune_cache_stats", "clear_tune_cache", "tune_key", "tune_scope",
    "layer_config", "plan_digest",
]


def autotune_plan(spec: ZooSpec, edges: np.ndarray, num_nodes: int, *,
                  backend: KernelBackend,
                  device: torch.device | str | None = None,
                  features=None, params: dict | None = None,
                  platform: Platform = GNNERATOR, max_n: int = 1024,
                  block_candidates: tuple[int, ...] = _BLOCK_CANDIDATES,
                  budget: int = 16, top_k: int = 4, seed: int = 0,
                  warmup: int = 1, reps: int = 3,
                  timeout_s: float | None = 30.0,
                  cache_dir=None, store=None, graph_key=None,
                  graph_version: int = 0) -> TuneRecord:
    """Pick the measured-fastest ModelPlan for (spec, graph, backend,
    device).

    Args:
      spec / edges / num_nodes: the model and graph to tune for.
      backend: the *resolved* kernel backend candidates run on (its name
        is part of the winner-store key).
      device: where the candidates run (part of the key); None is
        ``cuda``, and raises without a card.
      features: (N, F) node features; synthesized (seeded numpy, f32)
        when the graph is featureless — timing needs realistic shapes,
        not values. Used for timing only: never stored in ``store``.
      params: parameter tree to run with; drawn from ``seed`` with a
        ``torch.Generator`` when None.
      budget: max candidate plans measured, analytic plan included.
        ``budget <= 0`` skips measurement entirely and returns the
        analytic plan (``plan_source="analytic_fallback"``).
      top_k: per-layer analytic rank depth the search explores.
      seed: keys the run (and any synthesized features/params) — part of
        the memo key, so (arch, graph, budget, seed) is deterministic.
      warmup / reps / timeout_s: measurement protocol per candidate
        (see :func:`repro_torch.tune.measure.measure_plan`).
      cache_dir: winner-store directory (default: ``REPRO_PLAN_CACHE``).
      store: GraphStore the candidates' sharded builds go through
        (default: a private one).
      graph_key / graph_version: cache key naming the graph contents for
        ``store`` (default: a fingerprint) and its mutation generation.

    Measures under :func:`repro_torch.env.pinned`, which restores the
    caller's TF32, matmul-precision and cuDNN settings after. Returns
    the memoized :class:`~repro_torch.tune.store.TuneRecord`; repeat
    calls with the same key re-measure nothing.
    """
    from repro_torch.runtime.api import graph_fingerprint, resolve_device
    from repro_torch.runtime.cache import GraphStore

    dev = resolve_device(device)
    analytic = plan_model(spec, num_nodes, int(edges.shape[0]),
                          platform=platform, max_n=max_n,
                          block_candidates=block_candidates,
                          cache_dir=cache_dir)
    if budget <= 0:
        return TuneRecord(plan=analytic, plan_source="analytic_fallback",
                          winner_ms=None, analytic_ms=None, speedup=None,
                          candidates=(), scope=tune_scope(backend.name, dev))

    key = tune_key(spec, num_nodes, int(edges.shape[0]), platform=platform,
                   max_n=max_n, block_candidates=block_candidates,
                   backend_name=backend.name, device=dev, budget=budget,
                   seed=seed, reps=reps, warmup=warmup)
    rec = load_record(key, cache_dir)
    if rec is not None:
        return rec

    if features is None:
        rng = np.random.default_rng(seed)
        features = rng.standard_normal(
            (num_nodes, spec.in_dim), dtype=np.float32)
    if params is None:
        params = init_params(spec, torch.Generator().manual_seed(seed), dev)
    else:
        params = params_from_numpy(params, dev)
    if store is None:
        store = GraphStore()
    if graph_key is None:
        graph_key = graph_fingerprint(edges, num_nodes, features,
                                      version=graph_version)

    pruned: list[dict] = []
    cands = candidate_plans(spec, num_nodes, int(edges.shape[0]),
                            analytic=analytic, platform=platform,
                            max_n=max_n, block_candidates=block_candidates,
                            top_k=top_k, budget=budget,
                            backend_name=backend.name, pruned_out=pruned)
    measured: list[tuple[Measurement, object]] = []
    with env.pinned():
        for plan in cands:
            m = measure_plan(spec, plan, backend=backend, edges=edges,
                             num_nodes=num_nodes, features=features,
                             params=params, store=store,
                             graph_key=graph_key, device=dev,
                             graph_version=graph_version, warmup=warmup,
                             reps=reps, timeout_s=timeout_s)
            measured.append((m, plan))
    count_measurements(len(measured))

    ok = [(m, p) for m, p in measured if m.status == "ok"]
    analytic_digest = plan_digest(analytic)
    analytic_ms = next((m.median_ms for m, _ in ok
                        if m.digest == analytic_digest), None)
    scope = tune_scope(backend.name, dev)
    if ok:
        win_m, win_p = min(ok, key=lambda mp: mp[0].median_ms)
        speedup = (round(analytic_ms / win_m.median_ms, 4)
                   if analytic_ms else None)
        rec = TuneRecord(plan=win_p, plan_source="autotune",
                         winner_ms=round(win_m.median_ms, 4),
                         analytic_ms=(round(analytic_ms, 4)
                                      if analytic_ms else None),
                         speedup=speedup,
                         candidates=tuple(m for m, _ in measured),
                         scope=scope, pruned=tuple(pruned))
    else:
        # every candidate failed (the analytic plan too): serve the
        # analytic plan anyway — the only choice that needs no
        # measurement to justify — and record why
        rec = TuneRecord(plan=analytic, plan_source="analytic_fallback",
                         winner_ms=None, analytic_ms=None, speedup=None,
                         candidates=tuple(m for m, _ in measured),
                         scope=scope, pruned=tuple(pruned))
    save_record(key, rec, cache_dir)
    return rec
