"""Candidate enumeration for the empirical autotuner.

The analytic Table-I planner (:mod:`repro_torch.gnn.executor`) ranks every
(B, n, S, order, fused) config per layer by *estimated* layer time. The
search space here is built from that ranking — per layer, the analytic
top-k — combined into whole-model
:class:`~repro_torch.gnn.executor.ModelPlan`
candidates two ways:

  * **uniform sweeps** — every layer at analytic rank r (r = 0 is the
    analytic plan itself, always candidate #0 so the measured winner can
    never lose to it), the cheap way to explore "the model wants bigger /
    smaller blocks than the paper table thinks";
  * **coordinate sweeps** — one layer moved to rank r while the others
    stay at rank 0, which is what catches a single mis-modeled layer
    (VersaGNN's observation: sparse and dense regimes want different
    tiles, and real graphs mix them across layers).

Candidates are deduplicated by their configuration (:func:`plan_digest`,
the reference's: the list before pruning is the reference's), then
statically pruned (:func:`repro_torch.analyze.plan_lint.prune_candidates`:
legality violations and execution-identical duplicates — the port's
forward consumes only shard_n and per-layer ``fused``, so B/order/n/S
variants run the same kernels) and truncated to the measurement budget
in rank order. Pruned candidates are reported through ``pruned_out``,
never silently dropped.
"""
from __future__ import annotations

import hashlib
import json

from repro_torch.core.perf_model import GNNERATOR, Platform
from repro_torch.gnn.executor import (_BLOCK_CANDIDATES, LayerPlan, ModelPlan,
                                      enumerate_layer_plans)
from repro_torch.gnn.models import ZooSpec

_ORDERS = ("src_stationary", "dst_stationary")


def plan_digest(plan: ModelPlan) -> str:
    """Hash of the *executed* configuration only (B, n, S, order, fused
    per layer) — analytic estimates don't change what runs."""
    payload = json.dumps(
        [[p.layer, p.B, p.n, p.S, str(p.order), p.fused]
         for p in plan.layers], sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def layer_config(p: LayerPlan) -> dict:
    """The measured knobs of one layer plan, JSON-friendly."""
    return {"layer": p.layer, "B": p.B, "n": p.n, "S": p.S,
            "order": str(p.order), "fused": p.fused}


def _assemble(analytic: ModelPlan, layers: list[LayerPlan]) -> ModelPlan:
    return ModelPlan(arch=analytic.arch, num_nodes=analytic.num_nodes,
                     num_edges=analytic.num_edges,
                     onchip_bytes=analytic.onchip_bytes,
                     platform=analytic.platform, layers=tuple(layers))


def candidate_plans(spec: ZooSpec, num_nodes: int, num_edges: int, *,
                    analytic: ModelPlan,
                    platform: Platform = GNNERATOR, max_n: int = 1024,
                    block_candidates: tuple[int, ...] = _BLOCK_CANDIDATES,
                    top_k: int = 4, budget: int = 16,
                    backend_name: str | None = None,
                    pruned_out: list | None = None) -> list[ModelPlan]:
    """At most ``budget`` whole-model candidates, analytic plan first.

    ``top_k`` bounds the per-layer rank depth explored; the traversal
    order axis is widened to both orders (the analytic planner only ever
    proposes the Table-I best order for a grid width).

    Candidates are statically pruned before the budget truncation —
    legality checks run against ``backend_name``'s memory budget, and
    execution-identical duplicates are dropped — so every budget slot
    goes to a distinct, runnable config. The analytic candidate #0 is
    never pruned. ``pruned_out``, when given, receives one record per
    pruned candidate (``index``/``reason``/``rules``/``detail``)."""
    if budget <= 0:
        return []
    per_layer = [
        enumerate_layer_plans(spec, i, num_nodes, num_edges,
                              platform=platform, max_n=max_n,
                              block_candidates=block_candidates,
                              orders=_ORDERS)[:max(top_k, 1)]
        for i in range(len(analytic.layers))]

    out: list[ModelPlan] = []
    seen: set[str] = set()

    def push(layers: list[LayerPlan]) -> None:
        plan = _assemble(analytic, layers)
        digest = plan_digest(plan)
        if digest not in seen:
            seen.add(digest)
            out.append(plan)

    push(list(analytic.layers))          # candidate #0: the analytic plan
    depth = max(len(c) for c in per_layer)
    for rank in range(depth):            # uniform sweeps
        push([c[min(rank, len(c) - 1)] for c in per_layer])
    if len(per_layer) > 1:
        for rank in range(1, depth):     # coordinate sweeps
            for li, cands in enumerate(per_layer):
                if rank >= len(cands):
                    continue
                layers = list(analytic.layers)
                layers[li] = cands[rank]
                push(layers)

    from repro_torch.analyze.plan_lint import prune_candidates
    kept, pruned = prune_candidates(out, backend_name=backend_name)
    if pruned_out is not None:
        pruned_out.extend(pruned)
    return kept[:budget]
