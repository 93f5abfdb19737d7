"""repro_torch.analyze — static analysis over what the port produces.

The port of the reference's ``repro.analyze``. Passes, each decidable
before (or at) compile time, long before a bad config burns a
measurement or a hot-path sync backs a queue up:

  * **retrace**   — a warm entry point must build and compile nothing:
    the CSR index builds and compiles a request pays on first use,
    counted around real calls (:mod:`repro_torch.analyze.op_lint`, the
    counterpart of ``jaxpr_lint``), plus the ``torch.compile``-in-loop
    source rule in :mod:`.ast_lint`;
  * **dtype**     — one real forward under a dispatch mode: float64
    values outside an :func:`~.op_lint.allow_f64` scope, non-float32
    entry inputs, tensors past int32 element count (:mod:`.op_lint`);
  * **host-sync** — AST lint forbidding device→host syncs in the
    serving/runtime/kernels hot paths (:mod:`.ast_lint`);
  * **plan**      — LayerPlan/candidate legality + static pruning for
    the autotuner (:mod:`.plan_lint`);
  * **comm**      — counted collective bytes vs the PartitionPlan model
    for any mesh compile (:mod:`.comm_lint`, the counterpart of
    ``hlo_lint``);
  * **concurrency** — lock-discipline lint over serving/runtime/stream:
    guarded attributes written unlocked, acquisition-order cycles,
    blocking work under a lock, unsynchronized read-modify-writes,
    locked state escaping by reference (:mod:`.concurrency`);
  * **suppression** — stale ``analyze: allow(...)`` comments
    (:mod:`.suppress_lint`);
  * **lock-order**  — the *dynamic* half: an opt-in (``REPRO_LOCKSAN=1``)
    instrumented lock wrapper asserting a globally consistent
    acquisition order at run time (:mod:`.lock_sanitizer`).

Entry points: :func:`analyze_executable` (what
``runtime.compile(analyze=...)`` calls), :func:`preflight` (what
``Server.start(analyze=...)`` calls), and the ``python -m
repro_torch.launch.analyze`` CLI that runs everything over the port as
its gate.
"""
from __future__ import annotations

import time

from repro_torch.analyze import (ast_lint, comm_lint, concurrency,
                                 lock_sanitizer, op_lint, plan_lint,
                                 suppress_lint)
from repro_torch.analyze.report import (PASSES, SEVERITIES, AnalysisError,
                                        Finding, Report, severity_rank)

__all__ = [
    "Finding", "Report", "AnalysisError", "SEVERITIES", "PASSES",
    "severity_rank", "analyze_executable", "preflight",
    "ast_lint", "op_lint", "plan_lint", "comm_lint",
    "concurrency", "suppress_lint", "lock_sanitizer",
]


def analyze_executable(exe, *, probe: bool = False,
                       rtol: float = 0.02, graph=None) -> Report:
    """All compile-time passes over one compiled Executable.

    The dtype pass runs one real forward. ``probe`` additionally drives
    the entry points (full-graph forward twice, node batches) and reads
    the build counters — a real dynamic rebuild oracle, at the cost of
    real forwards; pass ``graph`` (the compiled-from GraphData) to
    extend the oracle over the streaming mutation path too. The
    host-sync and concurrency passes are source-level and package-wide,
    so they run in the CLI gate and the serving preflight, not per
    compile.
    """
    report = Report()

    t0 = time.perf_counter()
    report.extend(op_lint.check_executable(exe, probe=probe, graph=graph))
    report.timings_ms["retrace+dtype"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    report.extend(plan_lint.check_model_plan(
        exe.plan, backend_name=exe.backend_name))
    report.timings_ms["plan"] = (time.perf_counter() - t0) * 1e3

    if hasattr(exe, "comm_stats"):
        t0 = time.perf_counter()
        report.extend(comm_lint.check_sharded_executable(exe, rtol=rtol))
        report.timings_ms["comm"] = (time.perf_counter() - t0) * 1e3
    else:
        report.skipped["comm"] = \
            "single-device compile (no mesh): nothing on the wire"
    report.skipped["host-sync"] = \
        "source-level pass; run `python -m repro_torch.launch.analyze`"
    report.skipped["concurrency"] = \
        "source-level pass; run `python -m repro_torch.launch.analyze`"
    return report


def preflight(engine=None, *, probe: bool = False,
              rtol: float = 0.02) -> Report:
    """Serving-startup analysis: host-sync + lock-discipline lint over
    the deployed hot paths, plus every pass over each Executable the
    engine has already compiled (GNN engines compile lazily — pairs
    compiled after startup are covered by
    ``runtime.compile(analyze=...)``)."""
    report = Report()
    t0 = time.perf_counter()
    report.extend(ast_lint.lint_hot_paths())
    report.timings_ms["host-sync"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    report.extend(concurrency.lint_default_paths())
    report.timings_ms["concurrency"] = (time.perf_counter() - t0) * 1e3

    exes = getattr(engine, "_executables", None)
    if exes:
        for exe in list(exes.values()):
            report.merge(analyze_executable(exe, probe=probe, rtol=rtol))
        # per-exe source-pass skip notes are superseded: both ran above
        report.skipped.pop("host-sync", None)
        report.skipped.pop("concurrency", None)
    elif engine is not None:
        report.skipped["plan"] = report.skipped["retrace"] = \
            "no compiled executables yet (engine compiles lazily)"
    return report
