"""repro_torch.analyze against the reference, and its contract.

Where the reference runs under this JAX (its report, its mutation
oracle) the port is held to it on the same inputs. Where it does not
(its dtype pass, ``analyze_executable`` and the CLI gate need JAX APIs
this JAX removed), ``tests/test_analyze.py``'s cases are re-expressed for
torch: every lint catches its known-bad fixture, the port's tree is
clean, and the integration hooks (``runtime.compile(analyze=...)``,
``Server.start(analyze=...)``, the ``launch.analyze`` CLI) gate on the
report. Everything runs on the CPU (the kernels' plain versions).
"""
import contextlib
import importlib

import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.analyze import (AnalysisError, Finding, Report,
                                 analyze_executable, ast_lint, op_lint,
                                 preflight, severity_rank)
from repro_torch.gnn.models import ARCHS, ZooSpec, graph_signature
from repro_torch.graphs.datasets import make_dataset
from repro_torch.graphs.delta import GraphDelta
from repro_torch.graphs.patch import PatchState, fullest_pair_insert
from repro_torch.kernels import csr
from repro_torch.runtime.cache import compile_counts

# the module (``repro_torch.runtime.forward`` the attribute is the function)
FWD = importlib.import_module("repro_torch.runtime.forward")


def _setup(scale=0.05, arch="gcn", hidden=8):
    ds = make_dataset("cora", seed=0, scale=scale)
    spec = ZooSpec(arch, ds.profile.feature_dim, hidden,
                   ds.profile.num_classes, num_layers=2, heads=2)
    return ds, spec


def _compile(spec, ds, **kw):
    return runtime.compile(spec, ds, device="cpu", max_shard_n=64,
                           store=runtime.GraphStore(), **kw)


@pytest.fixture(scope="module")
def tiny():
    ds, spec = _setup()
    return ds, spec


# --------------------------------------------------------------------------
# report machinery: byte-equal to the reference's
# --------------------------------------------------------------------------

def _finding(rule="XX001", severity="error", pass_name="plan",
             message="boom", location="here"):
    return Finding(rule=rule, severity=severity, pass_name=pass_name,
                   message=message, location=location)


_MIXED = [("PL001", "error", "plan", "illegal B", "gcn/layer0"),
          ("HS004", "warning", "host-sync", "transfer", "a.py:3"),
          ("CC005", "info", "comm", "quality", "gcn[fennel]"),
          ("RT003", "error", "retrace", "rebuild", "Executable[gcn]"),
          ("ZZ001", "warning", "custom-pass", "unordered", "")]


def test_report_render_and_json_equal_the_reference():
    from repro.analyze.report import Finding as JaxFinding
    from repro.analyze.report import Report as JaxReport

    ours, theirs = Report(), JaxReport()
    for args in _MIXED:
        ours.add(Finding(*args))
        theirs.add(JaxFinding(*args))
    for rep in (ours, theirs):
        rep.timings_ms.update({"plan": 1.23456, "host-sync": 20.5})
        rep.skipped["comm"] = "single-device compile"
    assert ours.render() == theirs.render()
    assert ours.to_json() == theirs.to_json()
    for sev in ("info", "warning", "error", "never"):
        assert ours.failed(sev) == theirs.failed(sev)
    assert ours.worst() == theirs.worst() == "error"


def test_severity_rank_orders_and_validates():
    assert severity_rank("info") < severity_rank("warning") \
        < severity_rank("error")
    with pytest.raises(ValueError, match="unknown severity"):
        severity_rank("fatal")
    with pytest.raises(ValueError):
        _finding(severity="fatal")   # Finding validates eagerly


def test_report_thresholds_render_and_json_roundtrip():
    rep = Report()
    rep.add(_finding(severity="info"), _finding(severity="warning"))
    assert not rep.failed("error") and rep.failed("warning")
    assert rep.failed("info") and not rep.failed("never")
    assert rep.worst() == "warning"

    rep.add(_finding(severity="error", rule="PL001"))
    assert rep.failed("error") and rep.worst() == "error"
    assert rep.count("error") == 1

    text = rep.render()
    assert "PL001" in text and "1 error" in text
    doc = rep.to_json()
    assert doc["counts"] == {"info": 1, "warning": 1, "error": 1}
    back = [Finding.from_json(d) for d in doc["findings"]]
    assert back == rep.findings

    other = Report(timings_ms={"x": 1.0}, skipped={"comm": "why"})
    rep.merge(other)
    assert rep.timings_ms == {"x": 1.0} and rep.skipped == {"comm": "why"}


def test_analysis_error_carries_report():
    rep = Report(findings=[_finding(rule="CC001")])
    err = AnalysisError(rep)
    assert err.report is rep and "CC001" in str(err)


# --------------------------------------------------------------------------
# host-sync AST lint (torch rules)
# --------------------------------------------------------------------------

_HOT_FIXTURE = """\
import numpy as np
import torch

def serve(x, stream):
    a = x.item()
    torch.cuda.synchronize()
    stream.synchronize()
    b = float(torch.max(x))
    c = int(torch.ones(3).sum())
    d = x.cpu().numpy()
    e = x.tolist()
    f = np.asarray(torch.sum(x))
    for _ in range(3):
        fn = torch.compile(lambda y: y)
    while True:
        g = torch.jit.script(fn)
        h = torch.jit.trace(fn, x)
    return a, b, c, d, e, f, g, h
"""


def test_host_sync_fixture_fires_every_rule():
    fs = ast_lint.lint_source(_HOT_FIXTURE, "fixture.py")
    by_rule = {}
    for f in fs:
        by_rule.setdefault(f.rule, []).append(f)
    assert set(by_rule) == {"HS001", "HS002", "HS003", "HS004", "RT101"}
    assert len(by_rule["HS002"]) == 2          # torch.cuda and a stream
    assert len(by_rule["HS003"]) == 2          # torch.max, (...).sum()
    assert len(by_rule["HS004"]) == 3          # .cpu() once, .tolist, np
    assert len(by_rule["RT101"]) == 3          # compile, script, trace
    assert by_rule["HS001"][0].severity == "error"
    assert by_rule["HS002"][0].severity == "error"
    assert by_rule["HS003"][0].severity == "warning"
    assert by_rule["HS004"][0].severity == "warning"
    assert by_rule["RT101"][0].pass_name == "retrace"
    assert all(f.location.startswith("fixture.py:") for f in fs)


def test_host_sync_metadata_and_host_values_not_flagged():
    src = ("import numpy as np, torch\n"
           "def f(ids, t):\n"
           "    lo = float(torch.finfo(torch.float32).max)\n"
           "    hi = int(torch.iinfo(torch.int32).max)\n"
           "    n = int(ids.max())\n"          # numpy: not a torch expr
           "    a = np.asarray(ids)\n"
           "    s = t.shape[0]\n"
           "    x = t.item  # an attribute, not a call\n"
           "    torch.compile(f)\n"            # not inside a loop
           "    return lo, hi, n, a, s, x\n")
    assert ast_lint.lint_source(src) == []


def test_host_sync_suppression_by_rule_and_pass():
    src = ("def f(x):\n"
           "    a = x.item()  # analyze: allow(HS001)\n"
           "    b = x.cpu()  # analyze: allow(host-sync)\n"
           "    return a, b\n")
    assert ast_lint.lint_source(src) == []
    assert [f.rule for f in ast_lint.lint_source(src, suppress=False)] == \
        ["HS001", "HS004"]
    # a different rule's token does NOT suppress
    src2 = "def f(x):\n    return x.item()  # analyze: allow(HS002)\n"
    assert [f.rule for f in ast_lint.lint_source(src2)] == ["HS001"]


def test_host_sync_syntax_error_is_a_finding_not_a_crash():
    fs = ast_lint.lint_source("def broken(:\n", "bad.py")
    assert [f.rule for f in fs] == ["HS000"]
    assert fs[0].severity == "error"


def test_hot_paths_are_clean():
    """The port's serving/runtime/kernels trees carry zero host-sync
    findings: each deliberate materialization is annotated."""
    assert ast_lint.lint_hot_paths() == []


def test_hot_path_annotations_are_the_deliberate_readbacks():
    """Exactly the four annotated readbacks fire without suppression."""
    roots = [ast_lint.pathlib.Path(ast_lint.__file__).parents[1] / p
             for p in ast_lint.HOT_PATHS]
    found = []
    for root in roots:
        for f in sorted(root.rglob("*.py")):
            found += [x.location.split("repro_torch/")[1] for x in
                      ast_lint.lint_source(f.read_text(), f.as_posix(),
                                           suppress=False)]
    assert sorted(loc.split(":")[0] for loc in found) == [
        "runtime/executable.py", "runtime/executable.py",
        "serving/engine.py", "serving/engine.py"]


# --------------------------------------------------------------------------
# retrace pass: build stability
# --------------------------------------------------------------------------

def test_python_scalar_leaves_flagged():
    fs = op_lint.python_scalar_leaves(
        {"w": torch.ones(3), "eps": 0.5, "layers": [{"flag": True}]},
        name="params")
    assert [f.rule for f in fs] == ["RT002", "RT002"]
    assert fs[0].severity == "warning"
    # numpy scalars and 0-d tensors are typed — not flagged
    assert op_lint.python_scalar_leaves(
        {"eps": np.float32(0.5), "t": torch.tensor(0.5)}, name="p") == []


def test_build_stability_oracle(tiny):
    ds, spec = tiny
    blocks = torch.rand(2, 2, 4, 4)
    fs = op_lint.build_stability(lambda: csr.linear_index(blocks),
                                 [()] * 3, name="rebuilds")
    assert [f.rule for f in fs] == ["RT003"]
    assert fs[0].severity == "error" and "'linear': 3" in fs[0].message

    exe = _compile(spec, ds)
    assert op_lint.build_stability(exe.forward, [()] * 3,
                                   name="stable") == []
    # max_builds=0: a warm path that builds its first index is a finding
    fresh = _compile(spec, ds)
    fs = op_lint.build_stability(fresh.forward, [()] * 2, name="cold",
                                 max_builds=0)
    assert [f.rule for f in fs] == ["RT003"]

    fs = op_lint.build_stability(lambda: _compile(spec, ds), [()],
                                 name="compiles")
    assert [f.rule for f in fs] == ["RT003"]
    assert "1 compile(s)" in fs[0].message
    assert op_lint.build_stability(lambda: None, [], name="none") == []


def test_index_build_counters_count_each_graph_once(tiny):
    ds, spec = tiny
    exe = _compile(spec, ds)
    csr.reset_index_builds()
    assert csr.index_builds() == {"gather": 0, "linear": 0}
    exe.forward()
    exe.forward()
    assert csr.index_builds() == {"gather": 0, "linear": 1}
    _ = exe.gt.gather_index, exe.gt.gather_index
    assert csr.index_builds() == {"gather": 1, "linear": 1}
    csr.reset_index_builds()
    assert csr.index_builds() == {"gather": 0, "linear": 0}


def test_compile_counters(tiny):
    ds, spec = tiny
    before = compile_counts()
    store = runtime.GraphStore()
    for _ in range(2):
        runtime.compile(spec, ds, device="cpu", max_shard_n=64, store=store)
    after = compile_counts()
    assert after["compiles"] - before["compiles"] == 2
    assert after["graph_builds"] - before["graph_builds"] == 1   # a hit


# --------------------------------------------------------------------------
# dtype pass
# --------------------------------------------------------------------------

def test_dtype_f64_flagged_outside_the_scope_only():
    x = torch.ones(3)
    fs = op_lint.dtype_findings(lambda t: torch.sin(t.double()) * 2.0,
                                (x,), name="fix")
    assert "DT001" in {f.rule for f in fs}
    assert all(f.severity == "error" for f in fs if f.rule == "DT001")

    def scoped(t):
        with op_lint.allow_f64("fixture: deliberate"):
            return (torch.sin(t.double()) * 2.0).float()

    assert op_lint.dtype_findings(scoped, (x,), name="fix") == []
    # complex128 too
    fs = op_lint.dtype_findings(lambda t: t.to(torch.complex128),
                                (x,), name="fix")
    assert [f.rule for f in fs] == ["DT001"]


def test_allow_f64_is_scoped_and_needs_a_reason():
    with pytest.raises(ValueError):
        with op_lint.allow_f64(""):
            pass
    with op_lint.allow_f64("outer"):
        with op_lint.allow_f64("inner"):
            assert op_lint._f64_allowed()
        assert op_lint._f64_allowed()
    assert not op_lint._f64_allowed()


def test_dtype_non_float32_entry_flagged():
    fs = op_lint.dtype_findings(
        lambda p, h: h * p["eps"],
        ({"eps": 3.0}, torch.ones(3, dtype=torch.float16)), name="fix")
    assert [f.rule for f in fs if f.rule == "DT002"] == ["DT002", "DT002"]
    assert op_lint.dtype_findings(lambda h: h + 1, (torch.ones(3),),
                                  name="fix") == []


def test_dtype_int32_overflow_scale_flagged():
    big = torch.empty(2 ** 16, 2 ** 16, device="meta")   # 2^32, no memory
    fs = op_lint.dtype_findings(lambda x: x + 1, (big,), name="fix")
    assert "DT003" in {f.rule for f in fs}
    assert all(f.severity == "warning" for f in fs)


def test_gat_float64_runs_inside_its_scope(tiny):
    """gat's prefix sum is float64 on purpose: its forward is clean, and
    the same forward with the scope disabled fires DT001."""
    ds, _ = tiny
    _, spec = _setup(arch="gat")
    exe = _compile(spec, ds)
    args = (exe.params, exe._h_grouped)
    assert op_lint.dtype_findings(exe._forward_fn(), args, name="gat") == []

    real = FWD.allow_f64
    FWD.allow_f64 = lambda reason: contextlib.nullcontext()
    try:
        fs = op_lint.dtype_findings(exe._forward_fn(), args, name="gat")
    finally:
        FWD.allow_f64 = real
    assert "DT001" in {f.rule for f in fs}


# --------------------------------------------------------------------------
# the mutation oracle: the reference's test_mutation_oracle_* on both
# --------------------------------------------------------------------------

def _jax_exe(edge_slack):
    from repro import runtime as jax_runtime
    from repro.gnn.models import ZooSpec as JaxSpec
    from repro.graphs.datasets import make_dataset as jax_make_dataset

    jds = jax_make_dataset("cora", seed=0, scale=0.05)
    spec = JaxSpec("gcn", jds.profile.feature_dim, 8,
                   jds.profile.num_classes, num_layers=2)
    return jds, jax_runtime.compile(
        spec, jds, backend="reference", max_shard_n=64, mutable_graph=True,
        edge_slack=edge_slack, store=jax_runtime.GraphStore())


def test_mutation_oracle_clean_on_slack_padded_template_as_reference():
    from repro.analyze import jaxpr_lint
    from repro.graphs.delta import GraphDelta as JaxDelta
    from repro_torch.stream import random_delta

    ds, spec = _setup()
    exe = _compile(spec, ds, mutable_graph=True)
    rng = np.random.default_rng(0)
    deltas = [random_delta(ds, rng, edge_ops=4) for _ in range(4)]
    exe.forward()                       # the compiled graph's own index
    csr.reset_index_builds()
    assert op_lint.check_mutation_stability(
        exe, ds.edges, ds.profile.num_nodes, deltas) == []
    assert csr.index_builds() == {"gather": 0, "linear": 4}

    jds, jexe = _jax_exe(0.25)
    jdeltas = [JaxDelta(add_edges=d.add_edges, del_edges=d.del_edges,
                        add_nodes=d.add_nodes, add_features=d.add_features)
               for d in deltas]
    assert jaxpr_lint.check_mutation_stability(
        jexe, jds.edges, jds.profile.num_nodes, jdeltas) == []


def test_mutation_oracle_flags_unpadded_template_as_reference():
    from repro.analyze import jaxpr_lint
    from repro.graphs.delta import GraphDelta as JaxDelta

    ds, spec = _setup()
    exe = _compile(spec, ds, mutable_graph=True, edge_slack=0.0)
    norm, loops = graph_signature("gcn")
    probe = PatchState(ds.edges, ds.profile.num_nodes, exe.gt.n,
                       normalize=norm, add_self_loops=loops,
                       edge_capacity=int(exe.gt.edge_src.shape[-1]))
    delta = fullest_pair_insert(probe)
    fs = op_lint.check_mutation_stability(
        exe, ds.edges, ds.profile.num_nodes, [delta])
    assert [(f.rule, f.severity) for f in fs] == [("RT003", "error")]
    assert "broke the graph template" in fs[0].message

    jds, jexe = _jax_exe(0.0)
    jfs = jaxpr_lint.check_mutation_stability(
        jexe, jds.edges, jds.profile.num_nodes,
        [JaxDelta(add_edges=delta.add_edges)])
    assert [(f.rule, f.severity) for f in jfs] == [("RT003", "error")]


def test_mutation_oracle_flags_a_frozen_compile_that_grows():
    """The negative control of the card's phase: a mutable_graph=False
    compile has no slack, so an insert into its fullest pair is RT003."""
    ds, spec = _setup()
    exe = _compile(spec, ds)
    norm, loops = graph_signature("gcn")
    probe = PatchState(ds.edges, ds.profile.num_nodes, exe.gt.n,
                       normalize=norm, add_self_loops=loops,
                       edge_capacity=int(exe.gt.edge_src.shape[-1]))
    fs = op_lint.check_mutation_stability(
        exe, ds.edges, ds.profile.num_nodes,
        [fullest_pair_insert(probe)])
    assert [f.rule for f in fs] == ["RT003"]


def test_mutation_oracle_default_delta_round_trips(tiny):
    ds, spec = tiny
    exe = _compile(spec, ds)
    before = exe.forward().clone()
    assert op_lint.check_mutation_stability(
        exe, ds.edges, ds.profile.num_nodes) == []
    torch.testing.assert_close(exe.forward(), before, rtol=0, atol=0)


# --------------------------------------------------------------------------
# integration hooks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_analyze_executable_clean_with_probe(arch):
    ds, spec = _setup(arch=arch)
    exe = _compile(spec, ds, mutable_graph=True)
    rep = analyze_executable(exe, probe=True, graph=ds)
    assert rep.findings == []
    assert "comm" in rep.skipped and "host-sync" in rep.skipped
    assert set(rep.timings_ms) == {"retrace+dtype", "plan"}


def test_analyze_executable_featureless_runs_static_passes():
    ds, spec = _setup()
    exe = _compile(spec, (ds.edges, ds.profile.num_nodes))
    assert exe._h_grouped is None
    assert analyze_executable(exe, probe=True).findings == []


@pytest.mark.parametrize("partition", ["contiguous", "fennel"])
def test_sharded_compile_analyze_runs_the_comm_pass(tiny, partition):
    from repro_torch.launch.mesh import make_mesh_for

    ds, spec = tiny
    exe = _compile(spec, ds, mesh=make_mesh_for(4, model_parallel=2,
                                                device="cpu"),
                   partition=partition, mutable_graph=True, analyze="error")
    assert "comm" in exe.analysis.timings_ms
    assert "comm" not in exe.analysis.skipped
    assert exe.analysis.at_least("warning") == []
    # the probes too: each delta's graph builds one index per data group
    exe.forward()
    csr.reset_index_builds()
    assert analyze_executable(exe, probe=True, graph=ds).findings == []
    assert csr.index_builds() == {"gather": 0, "linear": 2 * exe.n_data}


def test_compile_analyze_modes(tiny):
    ds, spec = tiny
    with pytest.raises(ValueError, match="analyze"):
        _compile(spec, ds, analyze="loud")
    exe = _compile(spec, ds, analyze="error")
    assert exe.analysis is not None and exe.analysis.findings == []
    assert exe.analysis.timings_ms.keys() == {"retrace+dtype", "plan"}
    for mode in ("off", None):
        assert _compile(spec, ds, analyze=mode).analysis is None
    assert _compile(spec, ds, analyze="warn").analysis.findings == []


def test_compile_analyze_error_raises(tiny, monkeypatch):
    ds, spec = tiny
    import repro_torch.analyze as analyze_mod
    bad = Report(findings=[_finding(rule="PL001")])
    monkeypatch.setattr(analyze_mod, "analyze_executable",
                        lambda exe, **kw: bad)
    with pytest.raises(AnalysisError) as err:
        _compile(spec, ds, analyze="error")
    assert err.value.report is bad
    # "warn" downgrades the same report to a UserWarning
    with pytest.warns(UserWarning, match="PL001"):
        exe = _compile(spec, ds, analyze="warn")
    assert exe.analysis is bad


def test_compile_analyze_error_fires_on_a_float64_forward(tiny, monkeypatch):
    """The DT001 negative control: a forward step that calls .double()
    outside allow_f64 fails compile(analyze="error")."""
    ds, spec = tiny
    real = FWD.forward

    def widened(spec, params, gt, h, **kw):
        return real(spec, params, gt, h.double().float(), **kw)

    monkeypatch.setattr(FWD, "forward", widened)
    with pytest.raises(AnalysisError) as err:
        _compile(spec, ds, analyze="error")
    assert [f.rule for f in err.value.report.findings] == ["DT001"]


def test_preflight_without_engine_is_source_lints_only():
    rep = preflight()
    assert rep.findings == []
    assert set(rep.timings_ms) == {"host-sync", "concurrency"}
    assert rep.skipped == {}


def test_preflight_over_an_engine(tiny):
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest

    ds, spec = tiny
    engine = GNNServeEngine(device="cpu", max_shard_n=64)
    engine.register_graph("cora", ds)
    engine.register_model("gcn", spec, seed=0)
    rep = preflight(engine)
    assert "retrace" in rep.skipped            # nothing compiled yet
    engine.step(("gcn", "cora"), [NodeRequest("cora", [0, 1], model="gcn")])
    rep = preflight(engine, probe=True)
    assert rep.findings == [] and "host-sync" not in rep.skipped
    assert {"host-sync", "concurrency", "retrace+dtype", "plan"} <= \
        set(rep.timings_ms)


def test_server_start_analyze_gate(tiny, monkeypatch):
    from repro_torch.serving import Completed, SchedulerConfig, Server
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest

    ds, spec = tiny
    engine = GNNServeEngine(device="cpu", max_shard_n=64)
    engine.register_graph("cora", ds)
    engine.register_model("gcn", spec, seed=0)
    srv = Server(engine, SchedulerConfig(max_batch_size=2))

    with pytest.raises(ValueError, match="analyze"):
        srv.start(analyze="bogus")
    assert srv._thread is None

    import repro_torch.analyze as analyze_mod
    bad = Report(findings=[_finding(rule="HS001", pass_name="host-sync")])
    monkeypatch.setattr(analyze_mod, "preflight", lambda eng, **kw: bad)
    with pytest.raises(AnalysisError):
        srv.start(analyze="error")
    assert srv._thread is None          # refused before the thread started
    with pytest.warns(UserWarning, match="HS001"):
        srv.start(analyze="warn")
    srv.stop()

    monkeypatch.undo()
    srv.start(analyze="error")          # clean port: preflight passes
    try:
        assert srv._thread is not None
        out = srv.submit(NodeRequest("cora", [0, 1], model="gcn")).result(
            timeout_s=60.0)
        assert isinstance(out, Completed)
    finally:
        srv.stop()


def test_server_start_analyze_on_a_running_server_is_serialized(
        tiny, monkeypatch):
    """A second ``start(analyze=...)`` on a server whose driver thread is
    busy runs its preflight (real forwards over the engine's
    executables) under the step lock: no engine step overlaps it."""
    import time

    import repro_torch.analyze as analyze_mod
    from repro_torch.serving import Completed, SchedulerConfig, Server
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest

    ds, spec = tiny
    engine = GNNServeEngine(device="cpu", max_shard_n=64)
    engine.register_graph("cora", ds)
    engine.register_model("gcn", spec, seed=0)
    engine.step(("gcn", "cora"), [NodeRequest("cora", [0], model="gcn")])
    srv = Server(engine, SchedulerConfig(max_batch_size=1))

    inside, overlaps, preflights = [False], [], []
    real_preflight, real_step = analyze_mod.preflight, engine.step

    def preflight(eng, **kw):
        inside[0] = True
        try:
            time.sleep(0.05)            # room for a driver step to slip in
            rep = real_preflight(eng, probe=True, **kw)
            preflights.append(rep)
            return rep
        finally:
            inside[0] = False

    def step(key, payloads):
        overlaps.append(inside[0])
        return real_step(key, payloads)

    monkeypatch.setattr(analyze_mod, "preflight", preflight)
    monkeypatch.setattr(engine, "step", step)
    srv.start()
    try:
        tickets = [srv.submit(NodeRequest("cora", [i, i + 1], model="gcn"))
                   for i in range(12)]
        srv.start(analyze="warn")       # already running: thread kept
        outs = [t.result(timeout_s=60.0) for t in tickets]
    finally:
        srv.stop()
    assert all(isinstance(o, Completed) for o in outs)
    assert len(preflights) == 1 and preflights[0].findings == []
    assert overlaps and not any(overlaps)


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch import analyze as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.build_report(probe=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--fail-on", "error", "--no-probe"])


def test_cli_gate_clean_on_this_checkout(capsys):
    """`python -m repro_torch.launch.analyze --device cpu --fail-on
    error` is the port's gate: it exits 0 on the shipped tree, probes
    included."""
    from repro_torch.launch import analyze as cli

    rc = cli.main(["--fail-on", "error", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "0 error" in out
    rc = cli.main(["--fail-on", "never", "--device", "cpu", "--no-probe",
                   "--json"])
    assert rc == 0


def test_cli_gate_fails_on_a_finding(monkeypatch, capsys):
    from repro_torch.launch import analyze as cli

    monkeypatch.setattr(cli, "build_report", lambda **kw: Report(
        findings=[_finding(rule="HS004", severity="warning",
                           pass_name="host-sync")]))
    assert cli.main(["--fail-on", "warning", "--device", "cpu"]) == 1
    assert cli.main(["--fail-on", "error", "--device", "cpu"]) == 0
    assert "HS004" in capsys.readouterr().out
