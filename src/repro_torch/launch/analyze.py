"""Static-analysis CLI: run every repro_torch.analyze pass over the port.

The port of ``repro.launch.analyze``. The gate::

    PYTHONPATH=src python -m repro_torch.launch.analyze --fail-on error \
        --device cpu                       # the plain PyTorch versions
    PYTHONPATH=src python -m repro_torch.launch.analyze --fail-on error \
        --backend cuda                     # on the card, the kernels

What runs (on scaled-down Table-II graphs so the gate stays fast):

  * **host-sync** — AST lint over the serving/runtime/kernels hot paths;
  * **concurrency** — lock-discipline lint over serving/runtime/stream,
    plus the **suppression** audit flagging stale ``analyze: allow(...)``
    comments;
  * **plan**      — legality of the analytic ModelPlan for every zoo
    arch x Table-II dataset against the chosen backend's budget;
  * **retrace** / **dtype** — a compiled gcn Executable: the dtype pass
    over one real forward, plus (with probes, the default) build
    stability of the forward and the node-batch path, the STREAMING
    mutation path (6 random in-template GraphDeltas through the
    incremental patcher + ``update_graph`` on a ``mutable_graph=True``
    compile build one index per new graph and compile nothing) and a
    3-step ``runtime.fit`` (its indexes built once, one compile);
  * **comm**      — sharded compiles (contiguous, and fennel with the
    partition-quality gate) on a data 2 x model 2 ``LocalMesh``. The
    reference skips this pass with fewer than 2 devices; a ``LocalMesh``
    runs every rank on the one device, so here it always runs.

Exit status is 1 when any finding reaches ``--fail-on`` severity
(``never`` disables the gate); ``--json`` emits the machine-readable
report.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

from repro_torch.analyze import (Report, analyze_executable, ast_lint,
                                 concurrency, op_lint, plan_lint,
                                 suppress_lint)
from repro_torch.analyze.report import Finding
from repro_torch.gnn.models import ARCHS, ZooSpec
from repro_torch.graphs.datasets import TABLE2_DATASETS, make_dataset

# keeps every Table-II profile multi-shard but compile times in seconds
_SCALE = {"cora": 0.05, "citeseer": 0.02, "pubmed": 0.01}


def _spec_for(ds, arch: str, hidden: int = 8) -> ZooSpec:
    return ZooSpec(arch, ds.profile.feature_dim, hidden,
                   ds.profile.num_classes, num_layers=2)


def _cora():
    return make_dataset("cora", seed=0, scale=_SCALE["cora"])


def _plan_pass(report: Report, backend: str | None, max_n: int) -> None:
    from repro_torch.gnn.executor import plan_model

    t0 = time.perf_counter()
    for name in sorted(TABLE2_DATASETS):
        ds = make_dataset(name, seed=0, scale=_SCALE[name])
        for arch in ARCHS:
            spec = _spec_for(ds, arch)
            plan = plan_model(spec, ds.profile.num_nodes,
                              ds.edges.shape[0], max_n=max_n)
            for f in plan_lint.check_model_plan(plan, backend_name=backend):
                report.add(dataclasses.replace(
                    f, location=f"{name}/{f.location}"))
    report.timings_ms["plan"] = (time.perf_counter() - t0) * 1e3


def _executable_pass(report: Report, kw: dict, probe: bool) -> None:
    from repro_torch import runtime

    t0 = time.perf_counter()
    ds = _cora()
    exe = runtime.compile(_spec_for(ds, "gcn"), ds, **kw)
    sub = analyze_executable(exe, probe=probe, graph=ds)
    sub.skipped.pop("host-sync", None)   # runs for real in build_report
    sub.skipped.pop("concurrency", None)  # ditto
    sub.skipped.pop("comm", None)        # _comm_pass runs/records its own
    sub.timings_ms.clear()               # charged to this wall-clock below
    report.merge(sub)
    report.timings_ms["retrace+dtype"] = (time.perf_counter() - t0) * 1e3


def _fit_pass(report: Report, kw: dict) -> None:
    """Build stability of the train step: a short real fit compiles once
    (its own compile) and builds each index of its one graph once."""
    from repro_torch import runtime
    from repro_torch.kernels import csr
    from repro_torch.runtime.cache import compile_counts

    t0 = time.perf_counter()
    ds = _cora()
    idx0, cmp0 = csr.index_builds(), compile_counts()
    runtime.fit(_spec_for(ds, "gcn"), ds, steps=3, log=lambda _msg: None,
                **kw)
    idx1, cmp1 = csr.index_builds(), compile_counts()
    built = {k: idx1[k] - idx0[k] for k in idx1}
    compiled = {k: cmp1[k] - cmp0[k] for k in cmp1}
    if any(v > 1 for v in built.values()) or \
            any(v > 1 for v in compiled.values()):
        report.add(Finding(
            rule="RT003", severity="error", pass_name="retrace",
            message=f"3 full-batch train steps built index(es) {built} "
                    f"and made {compiled['compiles']} compile(s), "
                    f"{compiled['graph_builds']} graph build(s) (expected "
                    f"<= 1 each); the train step rebuilds per call",
            location="runtime.fit[gcn].step"))
    report.timings_ms["fit-retrace"] = (time.perf_counter() - t0) * 1e3


def _mutation_pass(report: Report, kw: dict) -> None:
    """Build-stability oracle over the STREAMING mutation path: a burst
    of random in-template deltas pushed through the incremental patcher
    and ``update_graph`` on a slack-padded (``mutable_graph=True``)
    compile builds one index per new graph and compiles nothing."""
    from repro_torch import runtime
    from repro_torch.stream import random_delta

    t0 = time.perf_counter()
    ds = _cora()
    exe = runtime.compile(_spec_for(ds, "gcn"), ds, mutable_graph=True,
                          **kw)
    rng = np.random.default_rng(0)
    deltas = [random_delta(ds, rng, edge_ops=4) for _ in range(6)]
    report.extend(op_lint.check_mutation_stability(
        exe, ds.edges, ds.profile.num_nodes, deltas,
        name="Executable[gcn,mutable]"))
    report.timings_ms["mutate-retrace"] = (time.perf_counter() - t0) * 1e3


def _comm_pass(report: Report, kw: dict, rtol: float) -> None:
    from repro_torch import runtime
    from repro_torch.analyze.comm_lint import (check_comm_stats,
                                               check_partition_quality)
    from repro_torch.launch.mesh import make_mesh_for

    t0 = time.perf_counter()
    mesh = make_mesh_for(4, model_parallel=2, device=kw["device"])
    ds = _cora()
    exe = runtime.compile(_spec_for(ds, "gcn"), ds, mesh=mesh, **kw)
    cs = exe.comm_stats()
    report.extend(check_comm_stats(
        cs, rtol=rtol,
        location=f"gcn data={cs['n_data']} model={cs['n_model']}"))
    # the fennel partitioner under the same contract, plus the
    # partition-quality gate: the selected partitioner's cross-group
    # edge fraction must never exceed the contiguous baseline's (CC005)
    fexe = runtime.compile(_spec_for(ds, "gcn"), ds, mesh=mesh,
                           partition="fennel", hub_cache=64, **kw)
    fcs = fexe.comm_stats()
    report.extend(check_comm_stats(
        fcs, rtol=rtol,
        location=f"gcn[fennel] data={fcs['n_data']} "
                 f"model={fcs['n_model']}"))
    report.extend(check_partition_quality(
        fexe.partition, exe.partition,
        location=f"gcn[fennel] data={fcs['n_data']}"))
    report.timings_ms["comm"] = (time.perf_counter() - t0) * 1e3


def build_report(*, device=None, backend: str | None = None,
                 max_n: int = 64, probe: bool = True,
                 rtol: float = 0.02) -> Report:
    """Run every pass over this checkout (see module docstring) on
    ``device`` (None: ``cuda``, which raises without a card)."""
    from repro_torch.runtime.api import resolve_device

    kw = dict(device=resolve_device(device), backend=backend,
              max_shard_n=max_n)
    report = Report()
    t0 = time.perf_counter()
    report.extend(ast_lint.lint_hot_paths())
    report.timings_ms["host-sync"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    report.extend(concurrency.lint_default_paths())
    report.timings_ms["concurrency"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    report.extend(suppress_lint.check_default_paths())
    report.timings_ms["suppression"] = (time.perf_counter() - t0) * 1e3

    _plan_pass(report, backend, max_n)
    _executable_pass(report, kw, probe)
    if probe:
        _mutation_pass(report, kw)
        _fit_pass(report, kw)
    _comm_pass(report, kw, rtol)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="repro_torch static-analysis gate (retrace, dtype, "
                    "host-sync, concurrency, suppression, plan legality, "
                    "comm contract)")
    ap.add_argument("--fail-on", default="error",
                    choices=("error", "warning", "info", "never"),
                    help="lowest severity that fails the gate "
                         "(default: error; 'never' always exits 0)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    ap.add_argument("--backend", default=None,
                    choices=["cuda", "reference"],
                    help="kernel backend analyzed/compiled against "
                         "(default: cuda)")
    ap.add_argument("--max-shard-n", type=int, default=64,
                    help="planner shard cap for the gate's tiny graphs")
    ap.add_argument("--rtol", type=float, default=0.02,
                    help="comm-contract relative tolerance")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the dynamic build-stability probes (real "
                         "forwards, deltas and a short fit)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report")
    args = ap.parse_args(argv)

    report = build_report(device=args.device, backend=args.backend,
                          max_n=args.max_shard_n, probe=not args.no_probe,
                          rtol=args.rtol)
    print(json.dumps(report.to_json(), indent=2) if args.json
          else report.render())
    return 1 if report.failed(args.fail_on) else 0


if __name__ == "__main__":
    sys.exit(main())
