"""Comm-contract audit: counted collectives vs the partition model.

The counterpart of the reference's ``analyze/hlo_lint.py``. The
reference measures a sharded forward's collectives from its compiled
HLO; the port counts them as they run (the mesh's comm log,
:mod:`repro_torch.dist.comm`). The contract is the same: the counted
wire bytes must match the analytic per-layer model, and the model must
agree with the PartitionPlan's independent derivation.

Rules:

  * **CC001** (error)   — counted all-gather wire bytes disagree with
    the analytic per-layer model beyond ``rtol``: the program moves more
    (or less) data than the plan accounts for.
  * **CC002** (error)   — the PartitionPlan's broadcast model disagrees
    with the analytic model: the two derivations of the same quantity
    have drifted (a modeling bug).
  * **CC003** (warning) — the run issued collective kinds the contract
    does not model (anything beyond the layer all-gathers and the
    model-axis psum all-reduces): unaccounted wire traffic.
  * **CC004** (info)    — no collectives at all while none are expected
    (a 1-rank mesh): the contract is vacuously satisfied.
  * **CC005** (error)   — partition-quality gate: the selected
    partitioner's cross-group edge fraction exceeds the contiguous
    baseline's. ``method="fennel"`` falls back to the identity placement
    when it would lose, so a regression here means the partitioner or
    its fallback broke.

For fennel plans the modeled all-gather volume is the halo broadcast
(``plan_allgather_bytes_per_layer``) plus the hub broadcast
(``plan_hub_bytes_per_layer``); CC001/CC002 check the hub terms as part
of the same totals.
"""
from __future__ import annotations

from repro_torch.analyze.report import Finding
from repro_torch.dist.comm import CollectiveStats

PASS = "comm"

# the kinds the sharded-GNN forward contract accounts for: the per-layer
# feature all-gathers (data axis) and the row-parallel psums (model axis)
MODELED_KINDS = frozenset({"all-gather", "all-reduce"})


def check_comm_contract(stats: CollectiveStats, *,
                        expected_allgather_bytes: float,
                        plan_allgather_bytes: float | None = None,
                        rtol: float = 0.02,
                        location: str = "") -> list[Finding]:
    """Findings for one run's collective traffic vs the contract (see
    the module docstring). Pure over the stats: testable without a
    mesh."""
    out: list[Finding] = []
    measured = stats.wire_bytes.get("all-gather", 0.0)
    expected = float(expected_allgather_bytes)
    tol = rtol * max(expected, 1.0)

    if abs(measured - expected) > tol:
        out.append(Finding(
            rule="CC001", severity="error", pass_name=PASS,
            message=f"counted all-gather wire bytes {measured:,.0f} != "
                    f"modeled {expected:,.0f} (tolerance {tol:,.0f}); the "
                    f"program and the comm model disagree",
            location=location))
    if plan_allgather_bytes is not None and \
            abs(float(plan_allgather_bytes) - expected) > tol:
        out.append(Finding(
            rule="CC002", severity="error", pass_name=PASS,
            message=f"PartitionPlan broadcast model "
                    f"{float(plan_allgather_bytes):,.0f} bytes != analytic "
                    f"per-layer model {expected:,.0f} (tolerance "
                    f"{tol:,.0f}); the two derivations drifted",
            location=location))
    unmodeled = sorted(set(stats.counts) - MODELED_KINDS)
    if unmodeled:
        extra = sum(stats.wire_bytes.get(k, 0.0) for k in unmodeled)
        out.append(Finding(
            rule="CC003", severity="warning", pass_name=PASS,
            message=f"unmodeled collective kinds {unmodeled} put "
                    f"{extra:,.0f} wire bytes on the interconnect outside "
                    f"the contract",
            location=location))
    if not stats.counts and expected == 0.0:
        out.append(Finding(
            rule="CC004", severity="info", pass_name=PASS,
            message="no collectives in the run and none expected (1-rank "
                    "mesh): contract vacuously holds",
            location=location))
    return out


def check_comm_stats(cs: dict, *, rtol: float = 0.02,
                     location: str = "") -> list[Finding]:
    """The contract over an already-computed
    :meth:`repro_torch.dist.gnn.ShardedExecutable.comm_stats` dict (which
    runs a forward, so callers holding one should not pay it twice)."""
    stats = CollectiveStats(
        operand_bytes={}, wire_bytes=dict(cs["measured_wire_bytes"]),
        counts=dict(cs["measured_counts"]))
    # the plan-side total is halo + hub broadcast (contiguous plans report
    # an all-zero hub dict)
    plan_total = sum(cs["plan_allgather_bytes_per_layer"].values()) + \
        sum(cs.get("plan_hub_bytes_per_layer", {}).values())
    return check_comm_contract(
        stats,
        expected_allgather_bytes=cs["expected_allgather_wire_bytes"],
        plan_allgather_bytes=plan_total,
        rtol=rtol, location=location)


def check_partition_quality(plan, baseline, *,
                            location: str = "") -> list[Finding]:
    """CC005: the selected partition plan must not move a larger fraction
    of edges across data groups than the contiguous baseline ``baseline``
    (same graph, same ``n_data``). Pure over the two plans."""
    sel = float(plan.cross_group_edge_frac)
    base = float(baseline.cross_group_edge_frac)
    if sel > base + 1e-9:
        return [Finding(
            rule="CC005", severity="error", pass_name=PASS,
            message=f"partition quality regressed: method={plan.method!r} "
                    f"moves {sel:.1%} of edges cross-group vs the "
                    f"contiguous baseline's {base:.1%}",
            location=location)]
    return [Finding(
        rule="CC005", severity="info", pass_name=PASS,
        message=f"partition quality: method={plan.method!r} cross-group "
                f"{sel:.1%} <= contiguous baseline {base:.1%} "
                f"(hub_rows={plan.hub_rows})",
        location=location)]


def check_sharded_executable(exe, *, rtol: float = 0.02) -> list[Finding]:
    """Run the contract over a compiled
    :class:`repro_torch.dist.gnn.ShardedExecutable` using its own
    :meth:`comm_stats` accounting."""
    cs = exe.comm_stats()
    return check_comm_stats(
        cs, rtol=rtol,
        location=f"ShardedExecutable[{exe.spec.arch}] "
                 f"data={cs['n_data']} model={cs['n_model']}")
