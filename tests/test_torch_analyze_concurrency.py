"""The port's concurrency analysis against the reference's.

``repro_torch.analyze.concurrency``, ``suppress_lint`` and
``lock_sanitizer`` are copies of the reference's modules: every CL/SUP
fixture of ``tests/test_analyze_concurrency.py`` gives JSON-equal
findings in both packages, the sanitizer gives the same rules on the
same lock scenarios, the port's own serving/runtime/stream trees are
clean (their ``guarded-by`` contracts are load-bearing), and a
multi-threaded stress run of one port Server under the sanitizer
resolves every ticket with no violation.
"""
import json
import pathlib
import textwrap
import threading
import time

import numpy as np
import pytest

from repro.analyze import concurrency as jax_concurrency
from repro.analyze import lock_sanitizer as jax_lock_sanitizer
from repro.analyze import suppress_lint as jax_suppress_lint
from repro_torch.analyze import (PASSES, concurrency, lock_sanitizer,
                                 suppress_lint)
from repro_torch.analyze.report import AnalysisError

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch"


def _rules(findings):
    return [f.rule for f in findings]


def _json(findings):
    return json.dumps([f.to_json() for f in findings], sort_keys=True)


# --------------------------------------------------------------------------
# the reference's known-bad fixtures, one per rule: port == reference
# --------------------------------------------------------------------------

CL_FIXTURES = {
    "cl001_annotated": ("""
        import threading
        class Guarded:
            def __init__(self):
                self.mu = threading.Lock()
                self.q = []  # guarded-by: mu
            def good(self):
                with self.mu:
                    self.q.append(1)
            def bad(self):
                self.q.append(2)
    """, ["CL001"]),
    "cl001_inferred": ("""
        import threading
        class Inferred:
            def __init__(self):
                self.mu = threading.Lock()
                self.n = 0
            def a(self):
                with self.mu:
                    self.n = 1
            def b(self):
                with self.mu:
                    self.n = 2
            def c(self):
                self.n = 3
    """, ["CL001"]),
    "cl001_external_token": ("""
        import threading
        class Documented:
            def __init__(self):
                self.mu = threading.Lock()
                self.n = {}  # guarded-by: Server._step_lock
            def a(self):
                with self.mu:
                    self.n["x"] = 1
            def b(self):
                self.n["y"] = 2
    """, []),
    "cl002_intra_class": ("""
        import threading
        class Inverted:
            def __init__(self):
                self.a = threading.Lock()
                self.b = threading.Lock()
            def fwd(self):
                with self.a:
                    with self.b:
                        pass
            def rev(self):
                with self.b:
                    with self.a:
                        pass
    """, ["CL002"]),
    "cl002_cross_class": ("""
        import threading
        class Store:
            def __init__(self):
                self.lock = threading.Lock()
                self.owner = Owner()
            def get(self):
                with self.lock:
                    self.owner.ping()
        class Owner:
            def __init__(self):
                self.mu = threading.Lock()
                self.store = Store()
            def ping(self):
                with self.mu:
                    pass
            def run(self):
                with self.mu:
                    self.store.get()
    """, ["CL002"]),
    "cl002_consistent": ("""
        import threading
        class Nested:
            def __init__(self):
                self.a = threading.Lock()
                self.b = threading.Lock()
            def one(self):
                with self.a:
                    with self.b:
                        pass
            def two(self):
                with self.a:
                    with self.b:
                        pass
    """, []),
    "cl003_blocking": ("""
        import threading, time
        class Blocky:
            def __init__(self):
                self.mu = threading.Lock()
            def fence(self, x):
                with self.mu:
                    x.block_until_ready()
            def nap(self):
                with self.mu:
                    time.sleep(0.5)
            def fetch(self, x):
                with self.mu:
                    return jax.device_get(x)
            def build(self, spec, ds):
                with self.mu:
                    return runtime.compile(spec, ds)
    """, ["CL003"] * 4),
    "cl003_lexical_only": ("""
        import threading, time
        class Fine:
            def __init__(self):
                self.mu = threading.Lock()
            def work(self):
                with self.mu:
                    n = 1
                time.sleep(0.5)
    """, []),
    "cl004_dict_counter": ("""
        class Counters:
            def __init__(self):
                self.stats = {"n": 0}
            def bump(self):
                self.stats["n"] += 1
    """, ["CL004"]),
    "cl004_scalar_lock_owner": ("""
        import threading
        class ScalarRace:
            def __init__(self):
                self.mu = threading.Lock()
                self.n = 0
            def bump(self):
                self.n += 1
        class SingleThreaded:
            def __init__(self):
                self.n = 0
            def bump(self):
                self.n += 1
    """, ["CL004"]),
    "cl004_annotation_exempts": ("""
        class Counters:
            def __init__(self):
                self.stats = {"n": 0}  # guarded-by: Server._cv
            def bump(self):
                self.stats["n"] += 1
    """, []),
    "cl005_escape": ("""
        import threading
        class Leaky:
            def __init__(self):
                self.mu = threading.Lock()
                self.items = {}
            def snapshot(self):
                with self.mu:
                    return self.items
            def copied(self):
                with self.mu:
                    return dict(self.items)
    """, ["CL005"]),
    "cl_allow_comments": ("""
        class Counters:
            def __init__(self):
                self.stats = {"n": 0}
            def bump(self):
                self.stats["n"] += 1  # analyze: allow(CL004)
            def bump2(self):
                self.stats["n"] += 1  # analyze: allow(concurrency)
    """, []),
    "cl000_syntax": ("def broken(:", ["CL000"]),
}


@pytest.mark.parametrize("name", sorted(CL_FIXTURES))
def test_cl_fixture_matches_reference(name):
    src, expected = CL_FIXTURES[name]
    src = textwrap.dedent(src)
    for suppress in (True, False):
        ours = concurrency.lint_source(src, "fix.py", suppress=suppress)
        theirs = jax_concurrency.lint_source(src, "fix.py",
                                             suppress=suppress)
        assert _json(ours) == _json(theirs), (name, suppress)
    assert _rules(concurrency.lint_source(src, "fix.py")) == expected


def test_cl_fixture_details():
    """The reference's per-fixture details (locations, messages,
    severities) hold for the port."""
    def lint(name):
        return concurrency.lint_source(
            textwrap.dedent(CL_FIXTURES[name][0]), "fix.py")

    fs = lint("cl001_annotated")
    assert fs[0].severity == "error" and "fix.py:11" in fs[0].location
    assert "guarded-by: mu" in fs[0].message
    fs = lint("cl001_inferred")
    assert "inferred" in fs[0].message and "fix.py:14" in fs[0].location
    msg = lint("cl002_intra_class")[0].message
    assert "Inverted.a" in msg and "Inverted.b" in msg
    msg = lint("cl002_cross_class")[0].message
    assert "Store.lock" in msg and "Owner.mu" in msg
    assert all(f.severity == "warning" for f in lint("cl003_blocking"))
    assert "ScalarRace" in lint("cl004_scalar_lock_owner")[0].message
    fs = lint("cl005_escape")
    assert fs[0].severity == "warning" and "fix.py:9" in fs[0].location
    src = textwrap.dedent(CL_FIXTURES["cl_allow_comments"][0])
    assert _rules(concurrency.lint_source(src, "fix.py", suppress=False)) \
        == ["CL004", "CL004"]


@pytest.mark.parametrize("pkg", ["serving", "runtime", "stream"])
def test_reference_tree_findings_match(pkg):
    """Over the reference's own serving/runtime/stream sources both
    passes give the same (empty) findings."""
    root = ROOT / "src" / "repro" / pkg
    ours = concurrency.lint_paths([root], repo_root=ROOT)
    theirs = jax_concurrency.lint_paths([root], repo_root=ROOT)
    assert _json(ours) == _json(theirs)
    assert ours == []


# --------------------------------------------------------------------------
# SUP001 stale suppressions, over the reference's fixtures
# --------------------------------------------------------------------------

SUP_FIXTURES = {
    "stale_token": ("x = 1  # analyze: allow(HS001)\n", ["SUP001"]),
    "meta_token": ("x = 1  # analyze: allow(HS001, SUP001)\n", []),
    "cl_token_live": ("""
        class C:
            def __init__(self):
                self.stats = {"n": 0}
            def bump(self):
                self.stats["n"] += 1  # analyze: allow(CL004)
    """, []),
    "hs_tokens_live": ("""
        import torch
        def f(x):
            a = x.cpu()  # analyze: allow(HS004)
            b = x.cpu()  # analyze: allow(host-sync)
            return a, b
    """, []),
    "mixed_live_and_stale": ("""
        import torch
        def f(x):
            return x.cpu()  # analyze: allow(HS004, CL004)
    """, ["SUP001"]),
}


@pytest.mark.parametrize("name", sorted(SUP_FIXTURES))
def test_sup001_fixture(name):
    src, expected = SUP_FIXTURES[name]
    fs = suppress_lint.check_source(textwrap.dedent(src), "fix.py")
    assert _rules(fs) == expected
    assert all(f.severity == "warning" for f in fs)


def test_sup001_mixed_tokens_name_only_the_stale_one():
    fs = suppress_lint.check_source(textwrap.dedent(
        SUP_FIXTURES["mixed_live_and_stale"][0]), "fix.py")
    assert "CL004" in fs[0].message and "HS004" not in fs[0].message


def test_sup001_stale_token_matches_reference():
    src = SUP_FIXTURES["stale_token"][0]
    assert _json(suppress_lint.check_source(src, "fix.py")) == \
        _json(jax_suppress_lint.check_source(src, "fix.py"))


def test_sup001_respects_pass_scoping():
    # a concurrency-only file can't "use" a host-sync token
    src = textwrap.dedent("""
        def f(x):
            return x.cpu()  # analyze: allow(HS004)
    """)
    assert suppress_lint.check_source(src, "f.py", passes=()) != []
    assert suppress_lint.check_source(src, "f.py",
                                      passes=("host-sync",)) == []


def test_sup001_pass_scoping_follows_the_port_tree():
    assert suppress_lint._passes_for(
        "src/repro_torch/serving/api.py") == ("host-sync", "concurrency")
    assert suppress_lint._passes_for(
        "src/repro_torch/kernels/csr.py") == ("host-sync",)
    assert suppress_lint._passes_for(
        "src/repro_torch/stream/trainer.py") == ("concurrency",)
    assert suppress_lint._passes_for(
        "src/repro_torch/tune/measure.py") == ()


# --------------------------------------------------------------------------
# the port's tree: zero findings, and the annotations are load-bearing
# --------------------------------------------------------------------------

def test_port_serving_runtime_stream_clean():
    assert concurrency.lint_default_paths() == []


def test_reference_pass_on_the_port_tree_is_clean():
    """The reference's own pass agrees: the port's restored guarded-by
    contracts leave no finding (it reported 27 CL004 without them)."""
    roots = [SRC / p for p in concurrency.ROOTS]
    assert jax_concurrency.lint_paths(roots, repo_root=ROOT) == []
    assert _json(concurrency.lint_paths(roots, repo_root=ROOT)) == \
        _json(jax_concurrency.lint_paths(roots, repo_root=ROOT))


def test_port_has_no_stale_suppressions():
    assert suppress_lint.check_default_paths() == []


def test_passes_registry_knows_the_passes():
    assert {"concurrency", "suppression", "lock-order"} <= set(PASSES)


def test_server_metrics_guard_is_enforced_not_just_documented():
    # drop the lock around one real self._m mutation: CL001 must fire
    src = (SRC / "serving" / "api.py").read_text()
    seeded = src.replace(
        '        with self._cv:\n            self._m["reloads"] += 1',
        '        self._m["reloads"] += 1')
    assert seeded != src, "reload() metrics bump moved; update this test"
    fs = concurrency.lint_source(seeded, "api.py")
    assert "CL001" in _rules(fs)
    assert any("Server._m" in f.message for f in fs)


@pytest.mark.parametrize("path,contract,at_least", [
    ("serving/gnn_engine.py",
     "# guarded-by: Server._step_lock (step/reload/mutate serialized)", 10),
    ("serving/engine.py", "# guarded-by: Server._step_lock", 6),
    ("stream/trainer.py", "# guarded-by: driver", 5),
])
def test_restored_contracts_are_load_bearing(path, contract, at_least):
    # strip one documented single-writer invariant: every unsynchronized
    # stats += it covers must resurface as CL004
    src = (SRC / path).read_text()
    seeded = src.replace(contract, "")
    assert seeded != src
    fs = concurrency.lint_source(seeded, path)
    assert _rules(fs).count("CL004") >= at_least


def test_graph_store_guard_is_enforced():
    # a stats bump moved outside the store lock breaks the _lock contract
    src = (SRC / "runtime" / "cache.py").read_text()
    seeded = src.replace(
        '    def evict(self, graph_key=None) -> None:\n',
        '    def bump(self):\n        self.stats["hits"] += 1\n\n'
        '    def evict(self, graph_key=None) -> None:\n')
    assert seeded != src
    fs = concurrency.lint_source(seeded, "cache.py")
    assert _rules(fs) == ["CL001"] and "GraphStore.stats" in fs[0].message


def test_take_dirty_without_its_lock_is_flagged():
    src = (SRC / "serving" / "gnn_engine.py").read_text()
    seeded = src.replace(
        "        with self._dirty_lock:\n"
        "            return self._dirty.pop(graph, "
        "np.empty(0, dtype=np.int64))",
        "        return self._dirty.pop(graph, "
        "np.empty(0, dtype=np.int64))")
    assert seeded != src, "take_dirty changed; update this test"
    fs = concurrency.lint_source(seeded, "gnn_engine.py")
    assert any(f.rule == "CL001" and "_dirty" in f.message for f in fs)


# --------------------------------------------------------------------------
# lock sanitizer (dynamic half): same rules as the reference's
# --------------------------------------------------------------------------

def _run_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join()


def _inversion(mod):
    a, b = mod.new_lock("A"), mod.new_lock("B")

    def fwd():
        with a:
            with b:
                pass

    def rev():
        with b:
            with a:
                pass

    _run_thread(fwd)
    _run_thread(rev)


def _consistent(mod):
    a, b = mod.new_lock("A"), mod.new_lock("B")
    for _ in range(3):
        with a:
            with b:
                pass


def _three_cycle(mod):
    locks = [mod.new_lock(n) for n in "ABC"]

    def take(i, j):
        with locks[i]:
            with locks[j]:
                pass

    for i, j in [(0, 1), (1, 2), (2, 0)]:   # A->B, B->C, C->A
        _run_thread(lambda i=i, j=j: take(i, j))


def _hold_vs_wait(mod):
    cv = mod.new_condition("CV")

    def waiter():
        with cv:
            cv.wait(timeout=1.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.08)                      # waiter parked > hold_ms
    with cv:
        cv.notify_all()
    t.join()
    slow = mod.new_lock("SLOW")
    with slow:
        time.sleep(0.06)


def _reentrant(mod):
    r = mod.new_rlock("R")
    with r:
        with r:
            pass


SCENARIOS = {
    "inversion": (_inversion, ["LS001"]),
    "consistent": (_consistent, []),
    "three_cycle": (_three_cycle, ["LS001"]),
    "hold_vs_wait": (_hold_vs_wait, ["LS002"]),
    "reentrant": (_reentrant, []),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sanitizer_scenario_matches_reference(name):
    scenario, expected = SCENARIOS[name]
    got = {}
    for label, mod in (("port", lock_sanitizer),
                       ("reference", jax_lock_sanitizer)):
        with mod.sanitize(hold_ms=30) as san:
            scenario(mod)
            got[label] = (_rules(san.findings()), san.acquisitions)
    assert got["port"] == got["reference"]
    assert got["port"][0] == expected


def test_sanitizer_inversion_details():
    with lock_sanitizer.sanitize() as san:
        _inversion(lock_sanitizer)
        fs = san.findings()
        assert "A" in fs[0].message and "B" in fs[0].message
        with pytest.raises(AnalysisError):
            san.assert_clean()


def test_sanitizer_consistent_order_counts_acquisitions():
    with lock_sanitizer.sanitize() as san:
        _consistent(lock_sanitizer)
        san.assert_clean()
        assert san.acquisitions == 6


def test_sanitizer_long_hold_names_the_lock():
    with lock_sanitizer.sanitize(hold_ms=30) as san:
        _hold_vs_wait(lock_sanitizer)
        fs = san.findings()
        assert "SLOW" in fs[0].message and fs[0].severity == "warning"
        san.assert_clean()                # a warning does not fail it


def test_factories_return_plain_primitives_when_inactive(monkeypatch):
    monkeypatch.setattr(lock_sanitizer, "_ACTIVE", None)
    monkeypatch.delenv(lock_sanitizer.ENV, raising=False)
    assert not lock_sanitizer.enabled()
    assert lock_sanitizer.current() is None
    lk = lock_sanitizer.new_lock("x")
    assert not isinstance(lk, lock_sanitizer._SanLock)
    cv = lock_sanitizer.new_condition("y")
    assert isinstance(cv, threading.Condition)


def test_env_opt_in_installs_a_global_sanitizer(monkeypatch):
    monkeypatch.setattr(lock_sanitizer, "_ACTIVE", None)
    monkeypatch.setenv(lock_sanitizer.ENV, "1")
    assert lock_sanitizer.enabled()
    lk = lock_sanitizer.new_lock("x")
    assert isinstance(lk, lock_sanitizer._SanLock)
    assert lock_sanitizer.current() is lk._san


def test_port_locks_are_built_through_the_factories():
    """Every lock of the server, the GNN engine and the graph store is a
    sanitizer lock under the reference's names when one is active."""
    from repro_torch.serving import GNNServeEngine, Server

    with lock_sanitizer.sanitize():
        engine = GNNServeEngine(device="cpu")
        server = Server(engine)
        names = {server._cv._lock.name, server._step_lock.name,
                 engine._dirty_lock.name, engine.store._lock.name}
    assert names == {"Server._cv", "Server._step_lock",
                     "GNNServeEngine._dirty_lock", "GraphStore._lock"}


# --------------------------------------------------------------------------
# multi-threaded stress: one port Server, concurrent submit/poll/mutate/
# reload/trainer traffic under the sanitizer
# --------------------------------------------------------------------------

N_SUBMIT_THREADS = 3
SUBMITS_PER_THREAD = 40
N_MUTATIONS = 20


def test_server_stress_mutate_while_serving_under_sanitizer():
    from repro_torch.gnn.models import ZooSpec
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.serving import Completed, SchedulerConfig, Server
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest
    from repro_torch.stream import StreamTrainer, random_delta

    data = make_dataset("cora", seed=0, scale=0.05)
    n_nodes = data.profile.num_nodes
    spec = ZooSpec("gcn", data.profile.feature_dim, 8,
                   data.profile.num_classes, num_layers=2)

    # hold_ms high: compiles legitimately run under the store lock here;
    # the assertion below is "no findings AT ALL"
    with lock_sanitizer.sanitize(hold_ms=60_000) as san:
        engine = GNNServeEngine(device="cpu", max_shard_n=64,
                                streaming=True)
        engine.register_graph("g", data)
        engine.register_model("gcn", spec)
        server = Server(engine, SchedulerConfig(max_batch_size=8,
                                                max_queue_depth=1024))
        server.start()
        trainer = StreamTrainer(server, graph="g", model="gcn",
                                batch_nodes=8, fanout=(3, 3),
                                steps_per_round=2, log=lambda s: None)

        tickets = [[] for _ in range(N_SUBMIT_THREADS)]
        errors = []

        def submitter(slot, seed):
            rng = np.random.default_rng(seed)
            try:
                for _ in range(SUBMITS_PER_THREAD):
                    ids = rng.integers(0, n_nodes, size=4)
                    t = server.submit(NodeRequest("g", ids, model="gcn"))
                    tickets[slot].append(t)
                    t.poll()                      # concurrent poll traffic
                    time.sleep(0.001)
            except Exception as err:              # surfaced after join
                errors.append(err)

        def mutator():
            rng = np.random.default_rng(7)
            try:
                for m in range(N_MUTATIONS):
                    server.mutate("g", random_delta(data, rng, edge_ops=4))
                    if (m + 1) % 10 == 0:         # trainer + hot reload
                        trainer.round(force=True)
                    time.sleep(0.002)
            except Exception as err:
                errors.append(err)

        threads = [threading.Thread(target=submitter, args=(i, 100 + i))
                   for i in range(N_SUBMIT_THREADS)]
        threads.append(threading.Thread(target=mutator))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errors == []

        outcomes = [t.result(timeout_s=180.0)
                    for slot in tickets for t in slot]
        server.stop()

        assert len(outcomes) == N_SUBMIT_THREADS * SUBMITS_PER_THREAD
        bad = [o for o in outcomes if not isinstance(o, Completed)]
        assert bad == [], f"non-Completed outcomes: {bad[:5]}"
        assert engine.stats["mutations"] == N_MUTATIONS
        assert trainer.stats["rounds"] == N_MUTATIONS // 10
        assert trainer.stats["reloads"] == N_MUTATIONS // 10

        # the sanitizer watched real lock traffic and saw no violation
        assert san.acquisitions > 200
        assert san.findings() == []
        san.assert_clean()


def test_stream_launcher_reports_the_sanitizer(monkeypatch, capsys):
    """REPRO_LOCKSAN=1 instruments the stream launcher's run: clean, and
    its lock findings are in the result."""
    from repro_torch.launch import stream

    monkeypatch.setattr(lock_sanitizer, "_ACTIVE", None)
    monkeypatch.setenv(lock_sanitizer.ENV, "1")
    out = stream.run(stream.parser().parse_args(
        ["--device", "cpu", "--scale", "0.05", "--shard-n", "64",
         "--steps", "2", "--mutations", "4", "--finetune-every", "2",
         "--requests-per-mutation", "2"]))
    text = capsys.readouterr().out
    assert out["ok"] and "lock sanitizer active" in text
    assert not [f for f in out["lock_findings"] if f["rule"] == "LS001"]
    assert lock_sanitizer.current().acquisitions > 0


# --------------------------------------------------------------------------
# CLI gate: concurrency + suppression wired in, --json schema stable
# --------------------------------------------------------------------------

def test_cli_gate_runs_concurrency_and_json_schema(capsys):
    from repro_torch.launch import analyze as cli

    rc = cli.main(["--fail-on", "error", "--device", "cpu", "--no-probe",
                   "--json"])
    data = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert set(data) == {"findings", "timings_ms", "skipped", "counts"}
    assert {"host-sync", "concurrency", "suppression", "comm"} <= \
        set(data["timings_ms"])
    assert set(data["counts"]) == {"info", "warning", "error"}
    assert data["counts"]["error"] == 0
    for f in data["findings"]:
        assert set(f) == {"rule", "severity", "pass_name", "message",
                          "location"}


def test_preflight_includes_concurrency_pass():
    from repro_torch.analyze import preflight

    rep = preflight()
    assert "concurrency" in rep.timings_ms
    assert rep.findings == []
