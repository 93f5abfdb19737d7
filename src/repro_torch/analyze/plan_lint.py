"""Plan-legality checker: static constraints over (Layer|Model)Plans.

Every constraint here is decidable from the plan alone — before any
kernel runs (VersaGNN's tiling-legality observation). The autotuner
(:func:`repro_torch.tune.search.candidate_plans`) runs
:func:`prune_candidates` over its search space so doomed configs are
rejected for free instead of burning a measurement timeout each.

Rules:

  * **PL001** (error)   — feature block outside ``1 <= B <= d_agg``:
    dimension-blocking cannot block more dims than exist.
  * **PL002** (error)   — shard grid inconsistent: ``n < 1`` or
    ``S != ceil(N / n)`` (the forward reshapes (S·n, d); a wrong S either
    drops rows or indexes past the grid).
  * **PL003** (error)   — working set (src block + dst accumulators +
    adjacency block) exceeds the memory budget: the backend's kernel
    scratch for fused plans (pallas: 16 MiB VMEM), the platform's
    on-chip budget otherwise.
  * **PL004** (error)   — ``fused`` on a non-fusable arch: the fused
    aggregate+extract kernel assumes linear aggregation with the dense
    transform after it (gcn only today).
  * **PL005** (error)   — unknown traversal order (Table I defines
    src- and dst-stationary; anything else never reaches a kernel).
  * **PL006** (warning) — activation grid S·n·d_agg past int32 element
    count: flattened int32 indexing wraps at reddit scale.
  * **PL007** (warning) — over half the shard grid is padding
    (S·n >= 2·N): legal, but the kernels spend most of their time on
    zero rows — a smaller n dominates.

Beyond legality, :func:`prune_candidates` also drops candidates that are
*execution-identical* to an earlier one. This is the one place the port
deliberately differs from ``repro.analyze.plan_lint``: the port's
forward consumes only each layer's ``fused`` flag and the model-level
shard_n (``runtime/forward.py::_controller``), because its CSR kernels
pick their own tiles and ignore the feature block B and the traversal
order. So :func:`executed_digest` hashes (shard_n, per-layer fused),
where the reference's hashes (shard_n, per-layer (B, fused)); with the
reference's digest the tuner would time one program once per B.

The rules, their messages and ``BACKEND_SCRATCH_BYTES`` are the
reference's. The fused CUDA kernel stages only a tile of W in shared
memory, whatever n and B are (``kernels/csrc/fused_gnn.cu``), so the
``cuda`` backend has no entry there and falls back to the plan's
platform budget, as any unlisted backend does.
"""
from __future__ import annotations

import hashlib
import json

from repro_torch.analyze.report import Finding
from repro_torch.gnn.executor import LayerPlan, ModelPlan
from repro_torch.utils import cdiv

PASS = "plan"

_INT32_MAX = 2 ** 31 - 1
_F32 = 4

VALID_ORDERS = frozenset({"src_stationary", "dst_stationary"})
FUSABLE_ARCHS = frozenset({"gcn"})

# kernel-scratch budget for *fused* plans, by backend: the fused kernel
# holds the whole working set in kernel-local memory (TPU VMEM for
# pallas). Backends not listed fall back to the plan's platform budget.
BACKEND_SCRATCH_BYTES: dict[str, int] = {
    "pallas": 16 * 2 ** 20,    # TPU VMEM per core
}


def scratch_budget_bytes(plan: ModelPlan, layer: LayerPlan,
                         backend_name: str | None) -> int:
    if layer.fused and backend_name in BACKEND_SCRATCH_BYTES:
        return BACKEND_SCRATCH_BYTES[backend_name]
    return plan.onchip_bytes


def check_layer(plan: ModelPlan, p: LayerPlan, *,
                backend_name: str | None = None) -> list[Finding]:
    """All plan-legality findings for one layer of ``plan``."""
    out: list[Finding] = []
    loc = f"{plan.arch}/L{p.layer}"
    N = plan.num_nodes

    if not 1 <= p.B <= p.d_agg:
        out.append(Finding(
            rule="PL001", severity="error", pass_name=PASS,
            message=f"feature block B={p.B} outside [1, d_agg={p.d_agg}]; "
                    f"dimension-blocking cannot block more dims than exist",
            location=loc))
    if p.n < 1 or p.S != cdiv(N, max(p.n, 1)):
        out.append(Finding(
            rule="PL002", severity="error", pass_name=PASS,
            message=f"shard grid inconsistent: n={p.n}, S={p.S}, but "
                    f"ceil(N={N} / n) = {cdiv(N, max(p.n, 1))} — the "
                    f"forward would drop rows or index past the grid",
            location=loc))
    budget = scratch_budget_bytes(plan, p, backend_name)
    used = p.onchip_bytes_used()
    if used > budget:
        kind = (f"backend {backend_name!r} kernel scratch" if p.fused
                and backend_name in BACKEND_SCRATCH_BYTES
                else f"platform {plan.platform!r} on-chip budget")
        out.append(Finding(
            rule="PL003", severity="error", pass_name=PASS,
            message=f"working set {used / 2**20:.2f} MiB (2nB + n^2 at "
                    f"n={p.n}, B={p.B}) exceeds {kind} "
                    f"{budget / 2**20:.2f} MiB",
            location=loc))
    if p.fused and plan.arch not in FUSABLE_ARCHS:
        out.append(Finding(
            rule="PL004", severity="error", pass_name=PASS,
            message=f"fused aggregate+extract requires linear aggregation "
                    f"(archs {sorted(FUSABLE_ARCHS)}); {plan.arch!r} "
                    f"must run two-stage",
            location=loc))
    if str(p.order) not in VALID_ORDERS:
        out.append(Finding(
            rule="PL005", severity="error", pass_name=PASS,
            message=f"unknown traversal order {p.order!r}; Table I "
                    f"defines {sorted(VALID_ORDERS)}",
            location=loc))
    if p.S * p.n * p.d_agg > _INT32_MAX:
        out.append(Finding(
            rule="PL006", severity="warning", pass_name=PASS,
            message=f"activation grid S*n*d = "
                    f"{p.S * p.n * p.d_agg:,} elements exceeds int32 — "
                    f"flattened int32 indexing wraps at this scale",
            location=loc))
    if N >= 1 and p.n >= 1 and p.S * p.n >= 2 * N:
        out.append(Finding(
            rule="PL007", severity="warning", pass_name=PASS,
            message=f"padding-dominated grid: S*n = {p.S * p.n} rows for "
                    f"N = {N} nodes (>= 50% padding); a smaller n wastes "
                    f"less kernel time on zero rows",
            location=loc))
    return out


def check_model_plan(plan: ModelPlan, *,
                     backend_name: str | None = None) -> list[Finding]:
    """Plan-legality findings for every layer of one ModelPlan."""
    out: list[Finding] = []
    for p in plan.layers:
        out.extend(check_layer(plan, p, backend_name=backend_name))
    return out


# --------------------------------------------------------------------------
# static pruning for the autotuner
# --------------------------------------------------------------------------

def executed_digest(plan: ModelPlan) -> str:
    """Hash of what the port's forward *actually consumes*: the
    model-level shard size plus each layer's ``fused`` flag. Plans
    agreeing here launch the same kernels on the same graph build,
    whatever their B/n/S/order say: B and the order reach no kernel of
    the port (the reference's digest keeps B, which its Pallas kernels
    tile by; see the module docstring)."""
    payload = json.dumps(
        [plan.shard_n] + [[p.layer, p.fused] for p in plan.layers],
        sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def prune_candidates(cands: list[ModelPlan], *,
                     backend_name: str | None = None,
                     ) -> tuple[list[ModelPlan], list[dict]]:
    """Split candidates into (kept, pruned-records).

    Candidate #0 (the analytic plan) is kept unconditionally — it is the
    fallback the tuner must always be able to serve, so policy never
    removes it. Later candidates are pruned when they carry an
    error-severity legality finding, or when their executed configuration
    duplicates an earlier kept candidate. Each pruned record carries
    ``{"index", "reason", "rules", "detail"}`` for the tune report."""
    kept: list[ModelPlan] = []
    pruned: list[dict] = []
    seen: dict[str, int] = {}
    for i, plan in enumerate(cands):
        digest = executed_digest(plan)
        if i == 0:
            kept.append(plan)
            seen[digest] = i
            continue
        errors = [f for f in check_model_plan(plan,
                                              backend_name=backend_name)
                  if f.severity == "error"]
        if errors:
            pruned.append({
                "index": i, "reason": "illegal",
                "rules": sorted({f.rule for f in errors}),
                "detail": errors[0].message})
            continue
        if digest in seen:
            pruned.append({
                "index": i, "reason": "duplicate-execution",
                "rules": [],
                "detail": f"executes identically to candidate "
                          f"#{seen[digest]} (same shard_n and per-layer "
                          f"fused; B/n/S/order reach no kernel of the "
                          f"port: its CSR kernels choose their own tiles)"})
            continue
        seen[digest] = i
        kept.append(plan)
    return kept, pruned
