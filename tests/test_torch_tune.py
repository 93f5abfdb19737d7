"""The port's plan sources against the reference package's.

``repro_torch.core.perf_model``, the planner's memo
(``repro_torch.gnn.executor``), ``repro_torch.analyze.plan_lint`` and
``repro_torch.tune`` are held to ``repro.core.perf_model``,
``repro.gnn.executor``, ``repro.analyze.plan_lint`` and ``repro.tune`` on
the same inputs: model times bitwise, plans and keys equal, findings
equal, the search list before pruning equal. The one deliberate
difference — the port's ``executed_digest`` drops the feature block B,
which reaches no kernel of the port — is pinned here. Then the
counterparts of ``tests/test_tune.py``'s cases run on ``device="cpu"``,
and the API surface (``runtime.compile`` / ``fit`` / ``GNNServeEngine`` /
``launch.serve``) with ``plan="autotune"``.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

# the reference's tune package imports repro.runtime, which must come first
from repro import runtime as jax_runtime  # noqa: I001
from repro import tune as jax_tune
from repro.analyze import plan_lint as jax_plan_lint
from repro.core import perf_model as jax_perf_model
from repro.gnn import executor as jax_executor
from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo
from repro.graphs.datasets import make_dataset as jax_make_dataset
from repro.kernels.registry import resolve as jax_resolve
from repro.tune.store import TuneRecord as JaxTuneRecord
from repro_torch import runtime, tune
from repro_torch.analyze import plan_lint
from repro_torch.core import perf_model
from repro_torch.gnn import executor
from repro_torch.gnn.models import ARCHS, ZooSpec
from repro_torch.graphs.datasets import TABLE2_DATASETS, make_dataset
from repro_torch.kernels.registry import OP_NAMES, resolve
from repro_torch.tune import store as tune_store
from repro_torch.tune.measure import Measurement
from repro_torch.tune.store import TUNER_VERSION, TuneRecord

TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")
PLATFORMS = ("GNNERATOR", "GNNERATOR_NOBLOCK", "HYGCN", "GPU_2080TI")
NETWORKS = ("gcn", "graphsage", "graphsage_pool")
# scaled so every Table-II profile still yields a multi-shard grid but
# each tuning rep stays milliseconds on the CPU (tests/test_tune.py's)
SCALES = {"cora": 0.02, "citeseer": 0.015, "pubmed": 0.003}


def _setup(dataset="cora", arch="gcn", scale=0.05, hidden=8):
    ds = make_dataset(dataset, seed=0, scale=scale)
    spec = ZooSpec(arch, ds.profile.feature_dim, hidden,
                   ds.profile.num_classes, num_layers=2)
    return ds, spec


def _jax_spec(spec: ZooSpec) -> JaxSpec:
    return JaxSpec(**dataclasses.asdict(spec))


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    monkeypatch.delenv("REPRO_PLAN_CACHE", raising=False)
    tune.clear_tune_cache()
    jax_tune.clear_tune_cache()
    yield
    tune.clear_tune_cache()
    jax_tune.clear_tune_cache()


class _BrokenBackend:
    """Every op raises: a backend that faults on any config."""
    name = "broken"


def _boom(*_a, **_kw):
    raise RuntimeError("kernel exploded")


for _op in OP_NAMES:
    setattr(_BrokenBackend, _op, staticmethod(_boom))


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

def test_speedup_table_bitwise():
    assert perf_model.speedup_table() == jax_perf_model.speedup_table()
    assert perf_model.speedup_table(block_b=16) == \
        jax_perf_model.speedup_table(block_b=16)


@pytest.mark.parametrize("network", NETWORKS)
@pytest.mark.parametrize("platform", PLATFORMS)
def test_model_time_bitwise(platform, network):
    ours, theirs = getattr(perf_model, platform), \
        getattr(jax_perf_model, platform)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for ds in jax_perf_model.DATASETS:          # reddit's profile too
        for kw in ({}, {"block_b": 16, "hidden": 32, "depth": 3})[
                :1 if ds == "reddit" else 2]:
            assert perf_model.model_time(ours, network, ds, **kw) == \
                jax_perf_model.model_time(theirs, network, ds, **kw), ds


@pytest.mark.parametrize("orders", [None, ("src_stationary",
                                           "dst_stationary")])
@pytest.mark.parametrize("arch", ARCHS)
def test_enumerate_layer_plans_equal(arch, orders):
    p = TABLE2_DATASETS["citeseer"]
    spec = ZooSpec(arch, p.feature_dim, 16, p.num_classes)
    for layer in range(2):
        kw = dict(max_n=512, orders=orders)
        ours = executor.enumerate_layer_plans(spec, layer, p.num_nodes,
                                              p.num_edges, **kw)
        theirs = jax_executor.enumerate_layer_plans(
            _jax_spec(spec), layer, p.num_nodes, p.num_edges, **kw)
        assert [x.to_json() for x in ours] == [x.to_json() for x in theirs]
        if orders is None:
            assert ours[0] == executor.plan_layer(
                spec, layer, p.num_nodes, p.num_edges, max_n=512)


@pytest.mark.parametrize("scope", [None, {"backend": "cuda", "seed": 3}])
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_key_hex_equal(arch, scope):
    spec = ZooSpec(arch, 500, 16, 3, heads=4)
    kw = dict(max_n=256, block_candidates=(8, 32), scope=scope)
    assert executor.plan_key(spec, 1000, 5000, platform=perf_model.HYGCN,
                             **kw) == \
        jax_executor.plan_key(_jax_spec(spec), 1000, 5000,
                              platform=jax_perf_model.HYGCN, **kw)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_plan_files_cross_packages(tmp_path, writer):
    """An analytic plan file written by either package's memo is a disk
    hit for the other's."""
    p = TABLE2_DATASETS["pubmed"]
    spec = ZooSpec("gcn", p.feature_dim, 16, p.num_classes)
    args = (p.num_nodes, p.num_edges)
    executor.clear_plan_cache()
    jax_executor.clear_plan_cache()
    if writer == "reference":
        written = jax_executor.plan_model(_jax_spec(spec), *args,
                                          cache_dir=tmp_path)
        read = executor.plan_model(spec, *args, cache_dir=tmp_path)
        stats = executor.plan_cache_stats()
    else:
        written = executor.plan_model(spec, *args, cache_dir=tmp_path)
        read = jax_executor.plan_model(_jax_spec(spec), *args,
                                       cache_dir=tmp_path)
        stats = jax_executor.plan_cache_stats()
    assert len(list(tmp_path.glob("*.json"))) == 1
    assert stats == {"hits": 0, "misses": 0, "disk_hits": 1}
    assert read.to_json() == written.to_json()
    executor.clear_plan_cache()
    jax_executor.clear_plan_cache()


def test_plan_memo_in_process_and_scope(tmp_path, monkeypatch):
    executor.clear_plan_cache()
    spec = ZooSpec("sage_mean", 500, 16, 3)
    a = executor.plan_model(spec, 2000, 9000, max_n=256)
    assert executor.plan_model(spec, 2000, 9000, max_n=256) is a
    assert executor.plan_cache_stats() == {"hits": 1, "misses": 1,
                                           "disk_hits": 0}
    scoped = executor.plan_model(spec, 2000, 9000, max_n=256,
                                 scope={"x": 1})
    assert scoped is not a and scoped == a
    # REPRO_PLAN_CACHE is the default disk directory
    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
    executor.plan_model(spec, 2000, 9000, max_n=128)
    assert len(list(tmp_path.glob("*.json"))) == 1
    executor.clear_plan_cache()
    assert executor.plan_cache_stats() == {"hits": 0, "misses": 0,
                                           "disk_hits": 0}


def _unpruned(monkeypatch):
    """Make both packages' candidate_plans return the list before
    pruning (prune_candidates keeps everything)."""
    keep_all = (lambda cands, **kw: (list(cands), []))
    monkeypatch.setattr(plan_lint, "prune_candidates", keep_all)
    monkeypatch.setattr(jax_plan_lint, "prune_candidates", keep_all)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dataset", sorted(SCALES))
def test_candidate_plans_before_pruning_equal(monkeypatch, arch, dataset):
    ds = make_dataset(dataset, seed=0, scale=SCALES[dataset] * 4)
    spec = ZooSpec(arch, ds.profile.feature_dim, 8,
                   ds.profile.num_classes)
    args = (ds.profile.num_nodes, ds.edges.shape[0])
    kw = dict(max_n=64, budget=64, top_k=4)

    def both():
        ours = tune.candidate_plans(
            spec, *args, analytic=executor.plan_model(spec, *args,
                                                      max_n=64), **kw)
        jspec = _jax_spec(spec)
        theirs = jax_tune.candidate_plans(
            jspec, *args, analytic=jax_executor.plan_model(jspec, *args,
                                                           max_n=64), **kw)
        return ours, theirs

    ours, theirs = both()               # pruned: the port's own rule
    assert tune.plan_digest(ours[0]) == jax_tune.plan_digest(theirs[0])
    _unpruned(monkeypatch)
    ours, theirs = both()
    assert [tune.plan_digest(p) for p in ours] == \
        [jax_tune.plan_digest(p) for p in theirs]
    assert [p.to_json() for p in ours] == [p.to_json() for p in theirs]


def _plan_fixtures(jplan):
    """tests/test_analyze.py's plan cases, built on a reference plan."""
    lp = jplan.layers[0]

    def with_layer(plan, layer):
        return dataclasses.replace(plan, layers=(layer,) + plan.layers[1:])

    fused = with_layer(jplan, dataclasses.replace(lp, fused=True))
    return {
        "analytic": jplan,
        "B_too_big": with_layer(jplan, dataclasses.replace(
            lp, B=lp.d_agg + 5)),
        "B_zero": with_layer(jplan, dataclasses.replace(lp, B=0)),
        "S_wrong": with_layer(jplan, dataclasses.replace(lp, S=lp.S + 3)),
        "order_unknown": with_layer(jplan, dataclasses.replace(
            lp, order="zigzag")),
        "fused_gcn": fused,
        "fused_gin": dataclasses.replace(fused, arch="gin"),
        "fused_huge": with_layer(jplan, dataclasses.replace(
            lp, n=2048, S=-(-jplan.num_nodes // 2048), B=lp.d_agg,
            fused=True)),
        "int32_wide": with_layer(jplan, dataclasses.replace(
            lp, d_agg=2 ** 31 // (lp.S * lp.n) + 1)),
        "padded": with_layer(jplan, dataclasses.replace(
            lp, n=4 * jplan.num_nodes, S=1)),
    }


def _findings(fs):
    return [(f.rule, f.severity, f.message, f.location) for f in fs]


@pytest.mark.parametrize("backend", ["pallas", None, "cuda"])
def test_check_model_plan_findings_equal(backend):
    ds = jax_make_dataset("cora", seed=0, scale=0.05)
    fired = set()
    for arch in ARCHS:
        jspec = JaxSpec(arch, ds.profile.feature_dim, 8,
                        ds.profile.num_classes, num_layers=2)
        jplan = jax_executor.plan_model(jspec, ds.profile.num_nodes,
                                        ds.edges.shape[0], max_n=64)
        for name, jp in _plan_fixtures(jplan).items():
            ours = executor.ModelPlan.from_json(jp.to_json())
            got = plan_lint.check_model_plan(ours, backend_name=backend)
            want = jax_plan_lint.check_model_plan(jp, backend_name=backend)
            assert _findings(got) == _findings(want), (arch, name)
            fired |= {f.rule for f in got}
    assert fired == {f"PL00{i}" for i in range(1, 8)}


def test_reference_tune_record_loads_and_json_roundtrips(tmp_path):
    jds = jax_make_dataset("cora", seed=0, scale=0.05)
    jspec = JaxSpec("gcn", jds.profile.feature_dim, 8,
                    jds.profile.num_classes)
    jrec = jax_tune.autotune_plan(jspec, jds.edges, jds.profile.num_nodes,
                                  backend=jax_resolve(None, "reference"),
                                  features=jds.features, max_n=64, budget=2,
                                  reps=1, cache_dir=tmp_path)
    blob = json.loads(json.dumps(jrec.to_json()))
    rec = TuneRecord.from_json(blob)
    assert rec.plan.to_json() == jrec.plan.to_json()
    assert rec.plan_source == jrec.plan_source
    assert [m.to_json() for m in rec.candidates] == \
        [m.to_json() for m in jrec.candidates]
    assert json.loads(json.dumps(rec.to_json())) == blob
    # and the port's own record, through the reference's schema
    ds, spec = _setup()
    ours = tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes,
                              backend=resolve("cuda"), device=CPU,
                              features=ds.features, max_n=64, budget=2,
                              reps=1)
    back = JaxTuneRecord.from_json(json.loads(json.dumps(ours.to_json())))
    assert back.plan.to_json() == ours.plan.to_json()
    assert TuneRecord.from_json(ours.to_json()) == ours


def test_measurement_json_roundtrip():
    m = Measurement(digest="abc", config=[{"layer": 0, "B": 8}],
                    status="ok", median_ms=1.25, reps_ms=(1.3, 1.25, 1.2),
                    warmup_ms=5.0)
    back = Measurement.from_json(json.loads(json.dumps(m.to_json())))
    assert back == m
    assert m.to_json() == jax_tune.Measurement.from_json(
        m.to_json()).to_json()


# ---------------------------------------------------------------------------
# the deliberate difference: executed_digest drops B
# ---------------------------------------------------------------------------

def test_block_only_variant_is_duplicate_in_port_not_in_reference():
    ds = jax_make_dataset("cora", seed=0, scale=0.05)
    jspec = JaxSpec("gcn", ds.profile.feature_dim, 8,
                    ds.profile.num_classes)
    jplan = jax_executor.plan_model(jspec, ds.profile.num_nodes,
                                    ds.edges.shape[0], max_n=64)
    lp = jplan.layers[0]
    jrebl = dataclasses.replace(jplan, layers=(dataclasses.replace(
        lp, B=max(1, lp.B // 2)),) + jplan.layers[1:])
    plan, rebl = (executor.ModelPlan.from_json(p.to_json())
                  for p in (jplan, jrebl))

    assert plan_lint.executed_digest(plan) == plan_lint.executed_digest(rebl)
    assert jax_plan_lint.executed_digest(jplan) != \
        jax_plan_lint.executed_digest(jrebl)
    kept, pruned = plan_lint.prune_candidates([plan, rebl])
    assert kept == [plan]
    assert [(p["index"], p["reason"]) for p in pruned] == \
        [(1, "duplicate-execution")]
    assert "reach no kernel" in pruned[0]["detail"]
    jkept, jpruned = jax_plan_lint.prune_candidates([jplan, jrebl])
    assert jkept == [jplan, jrebl] and jpruned == []
    # what does reach a kernel stays distinct: fused and shard_n
    flipped = dataclasses.replace(plan, layers=(dataclasses.replace(
        plan.layers[0], fused=not plan.layers[0].fused),) + plan.layers[1:])
    assert plan_lint.executed_digest(flipped) != \
        plan_lint.executed_digest(plan)
    other_n = dataclasses.replace(plan, layers=tuple(
        dataclasses.replace(p, n=p.n // 2) for p in plan.layers))
    assert plan_lint.executed_digest(other_n) != \
        plan_lint.executed_digest(plan)


@pytest.mark.parametrize("arch", ARCHS)
def test_pubmed_profile_executed_configs(arch):
    """Full-size Pubmed (planning only): every kept candidate builds the
    1024-node shard grid; gcn runs two programs (layer 1 fused or
    two-stage), every other arch one."""
    p = TABLE2_DATASETS["pubmed"]
    spec = ZooSpec(arch, p.feature_dim, 16, p.num_classes)
    analytic = executor.plan_model(spec, p.num_nodes, p.num_edges,
                                   max_n=1024)
    pruned = []
    kept = tune.candidate_plans(spec, p.num_nodes, p.num_edges,
                                analytic=analytic, max_n=1024, budget=8,
                                backend_name="cuda", pruned_out=pruned)
    assert {c.shard_n for c in kept} == {1024}
    assert len({plan_lint.executed_digest(c) for c in kept}) == len(kept)
    assert len(kept) == (2 if arch == "gcn" else 1)
    assert tune.plan_digest(kept[0]) == tune.plan_digest(analytic)
    assert all(r["reason"] == "duplicate-execution" for r in pruned)


# ---------------------------------------------------------------------------
# tests/test_tune.py's cases, on the CPU
# ---------------------------------------------------------------------------

class TestAutotuneMemoization:
    def _kw(self, ds, **over):
        kw = dict(backend=resolve("cuda"), device=CPU,
                  features=ds.features, max_n=64, budget=4, seed=0,
                  reps=2, warmup=1)
        kw.update(over)
        return kw

    def test_deterministic_and_memoized_in_process(self):
        ds, spec = _setup()
        kw = self._kw(ds)
        rec1 = tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes, **kw)
        stats = tune.tune_cache_stats()
        assert rec1.plan_source == "autotune"
        assert stats["measurements"] == rec1.n_measured > 0
        assert rec1.report()["candidates_failed"] == 0
        rec2 = tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes, **kw)
        stats = tune.tune_cache_stats()
        assert rec2 is rec1
        assert stats["hits"] == 1
        assert stats["measurements"] == rec1.n_measured
        assert rec1.scope["device"] == "cpu"

    def test_disk_memo_survives_restart(self, tmp_path):
        ds, spec = _setup()
        kw = self._kw(ds, budget=3, seed=1, cache_dir=tmp_path)
        rec1 = tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes, **kw)
        assert list(tmp_path.glob("tune-*.json"))
        tune.clear_tune_cache()                   # "new process"
        rec2 = tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes, **kw)
        stats = tune.tune_cache_stats()
        assert stats["disk_hits"] == 1 and stats["measurements"] == 0
        assert tune.plan_digest(rec2.plan) == tune.plan_digest(rec1.plan)
        assert rec2.winner_ms == rec1.winner_ms

    def test_corrupt_disk_entry_falls_back_to_retuning(self, tmp_path):
        ds, spec = _setup()
        key = tune.tune_key(spec, ds.profile.num_nodes, ds.edges.shape[0],
                            platform=executor.GNNERATOR, max_n=64,
                            block_candidates=executor._BLOCK_CANDIDATES,
                            backend_name="cuda", device=CPU, budget=3,
                            seed=0, reps=2, warmup=1)
        (tmp_path / f"tune-{key}.json").write_text("{not json!!")
        rec = tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes,
                                 **self._kw(ds, budget=3, cache_dir=tmp_path))
        stats = tune.tune_cache_stats()
        assert stats["corrupt"] == 1
        assert rec.plan_source == "autotune"
        assert stats["measurements"] == rec.n_measured > 0

    def test_stale_tuner_version_invalidates(self, tmp_path):
        ds, spec = _setup()
        kw = self._kw(ds, budget=3, seed=2, cache_dir=tmp_path)
        tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes, **kw)
        (path,) = tmp_path.glob("tune-*.json")
        blob = json.loads(path.read_text())
        blob["tuner_version"] = TUNER_VERSION + 1
        path.write_text(json.dumps(blob))
        tune.clear_tune_cache()
        rec = tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes, **kw)
        stats = tune.tune_cache_stats()
        assert stats["corrupt"] == 1 and stats["disk_hits"] == 0
        assert rec.plan_source == "autotune"
        assert stats["measurements"] > 0

    def test_budget_zero_is_analytic_fallback(self):
        ds, spec = _setup()
        rec = tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes,
                                 backend=resolve("cuda"), device=CPU,
                                 max_n=64, budget=0)
        assert rec.plan_source == "analytic_fallback"
        assert rec.n_measured == 0 and rec.winner_ms is None
        assert tune.tune_cache_stats()["measurements"] == 0
        analytic = executor.plan_model(spec, ds.profile.num_nodes,
                                       ds.edges.shape[0], max_n=64)
        assert tune.plan_digest(rec.plan) == tune.plan_digest(analytic)

    def test_all_candidates_failing_never_raises(self):
        ds, spec = _setup()
        rec = tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes,
                                 backend=_BrokenBackend(), device=CPU,
                                 features=ds.features, max_n=64, budget=3,
                                 reps=1)
        assert rec.plan_source == "analytic_fallback"
        assert rec.n_measured > 0
        assert all(m.status == "error" for m in rec.candidates)
        assert all("RuntimeError" in m.error for m in rec.candidates)
        assert rec.report()["candidates_failed"] == rec.n_measured

    def test_library_fault_propagates(self, monkeypatch):
        """A kernel library that cannot be built is no candidate's fault:
        it raises out of the tuner instead of becoming a data point."""
        from repro_torch.kernels import _lib

        def no_library(*_a, **_kw):
            raise _lib.LibraryError("nvcc not found")

        ds, spec = _setup()
        backend = _BrokenBackend()
        for op in OP_NAMES:
            monkeypatch.setattr(backend, op, no_library, raising=False)
        with pytest.raises(_lib.LibraryError, match="nvcc"):
            tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes,
                               backend=backend, device=CPU,
                               features=ds.features, max_n=64, budget=2,
                               reps=1)


class TestKeyScoping:
    def _key(self, spec, ds, **over):
        kw = dict(platform=executor.GNNERATOR, max_n=64,
                  block_candidates=executor._BLOCK_CANDIDATES,
                  backend_name="cuda", device=CPU, budget=4, seed=0, reps=3,
                  warmup=1)
        kw.update(over)
        return tune.tune_key(spec, ds.profile.num_nodes,
                             ds.edges.shape[0], **kw)

    @pytest.fixture
    def fake_card(self, monkeypatch):
        """describe() of a card, on a machine without one."""
        real = tune_store.env.describe

        def describe(device=None):
            d = real("cpu")
            if device is not None and torch.device(device).type == "cuda":
                d.update(device="NVIDIA H100 80GB HBM3", cuda_version="12.8")
            return d

        monkeypatch.setattr(tune_store.env, "describe", describe)

    def test_every_scope_axis_is_in_the_key(self, fake_card, monkeypatch):
        ds, spec = _setup()
        base = self._key(spec, ds)
        assert base == self._key(spec, ds)
        assert base != self._key(spec, ds, backend_name="reference")
        assert base != self._key(spec, ds, device=torch.device("cuda"))
        assert base != self._key(spec, ds, budget=5)
        assert base != self._key(spec, ds, seed=1)
        assert base != self._key(spec, ds, reps=2)
        assert base != self._key(spec, ds, warmup=2)
        with monkeypatch.context() as m:
            m.setattr(tune_store, "TUNER_VERSION", TUNER_VERSION + 1)
            assert base != self._key(spec, ds)
        with monkeypatch.context() as m:
            m.setattr(torch, "__version__", "0.0.0")
            assert base != self._key(spec, ds)
        assert base == self._key(spec, ds)

    def test_scope_names_the_environment(self, fake_card):
        scope = tune.tune_scope("cuda", CPU)
        assert scope == {"plan_source": "autotune", "backend": "cuda",
                         "device": "cpu", "torch_version": torch.__version__,
                         "cuda_version": torch.version.cuda,
                         "tuner_version": TUNER_VERSION}
        card = tune.tune_scope("cuda", "cuda")
        assert card["device"] == "NVIDIA H100 80GB HBM3"

    def test_cpu_or_reference_winner_never_serves_a_card_compile(
            self, fake_card):
        """The cuda backend runs its plain versions on CPU tensors: its
        CPU-timed winner, and any reference-backend winner, are stored
        under keys a compile on the card never reads."""
        ds, spec = _setup(scale=0.02)
        kw = dict(features=ds.features, max_n=16, budget=2, reps=1)
        for backend in ("cuda", "reference"):
            tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes,
                               backend=resolve(backend), device=CPU, **kw)
        stats = tune.tune_cache_stats()
        assert stats["misses"] == 2 and stats["measurements"] > 0
        card_key = self._key(spec, ds, max_n=16, budget=2, reps=1,
                             device=torch.device("cuda"))
        assert tune_store.load_record(card_key) is None
        assert tune.tune_cache_stats()["misses"] == 3
        for backend in ("cuda", "reference"):
            assert tune_store.load_record(self._key(
                spec, ds, max_n=16, budget=2, reps=1,
                backend_name=backend)) is not None

    def test_winners_not_shared_across_backends(self):
        ds, spec = _setup(scale=0.02)
        kw = dict(features=ds.features, max_n=16, budget=2, reps=1,
                  device=CPU)
        tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes,
                           backend=resolve("reference"), **kw)
        n_ref = tune.tune_cache_stats()["measurements"]
        assert n_ref > 0
        tune.autotune_plan(spec, ds.edges, ds.profile.num_nodes,
                           backend=resolve("cuda"), **kw)
        stats = tune.tune_cache_stats()
        assert stats["misses"] == 2
        assert stats["measurements"] > n_ref

    def test_analytic_plans_still_shared_across_backends(self):
        ds, spec = _setup(scale=0.02)
        store = runtime.GraphStore()
        kw = dict(max_shard_n=16, store=store, graph_key="cora-tiny",
                  device="cpu")
        ref = runtime.compile(spec, ds, backend="reference", **kw)
        cu = runtime.compile(spec, ds, backend="cuda", **kw)
        assert ref.plan is cu.plan


class TestRuntimeIntegration:
    def test_compile_autotune_memoizes_and_reports(self, tmp_path):
        ds, spec = _setup()
        store = runtime.GraphStore()
        kw = dict(device="cpu", plan="autotune", tune_budget=3,
                  tune_reps=2, max_shard_n=64, store=store,
                  graph_key="cora-s05", plan_cache_dir=tmp_path)
        exe = runtime.compile(spec, ds, **kw)
        assert exe.plan_source == "autotune"
        assert exe.tune_report["candidates_measured"] > 0
        assert exe.tune_report["candidates_failed"] == 0
        head, *rest = exe.summary().splitlines()
        assert "plan=autotune" in head
        assert any("autotune: winner" in ln for ln in rest)
        n = runtime.tune_cache_stats()["measurements"]
        exe2 = runtime.compile(spec, ds, **kw)
        assert runtime.tune_cache_stats()["measurements"] == n
        assert exe2.plan == exe.plan
        runtime.clear_tune_cache()
        runtime.compile(spec, ds, **kw)
        assert runtime.tune_cache_stats()["disk_hits"] == 1
        # the plan file round-trips through both packages
        exe.save_plan(tmp_path / "plan.json")
        blob = json.loads((tmp_path / "plan.json").read_text())
        assert blob == exe.plan_json()
        assert executor.ModelPlan.from_json(blob) == exe.plan
        assert jax_executor.ModelPlan.from_json(blob).to_json() == blob

    def test_featureless_autotune_keeps_tuner_features_out_of_the_store(
            self):
        """The tuner times a featureless graph with features it draws
        itself; they never become the graph's. The tuned compile's
        forward raises as the analytic one does, and a later featureful
        compile on the same store and key serves the real features."""
        ds, spec = _setup()
        store = runtime.GraphStore()
        kw = dict(device="cpu", max_shard_n=64, store=store,
                  graph_key="cora-bare", tune_budget=3, tune_reps=1)
        bare = (ds.edges, ds.profile.num_nodes)
        for plan in ("autotune", "analytic"):
            exe = runtime.compile(spec, bare, plan=plan, **kw)
            with pytest.raises(ValueError, match="compiled without features"):
                exe.forward()
        exe = runtime.compile(spec, (*bare, ds.features), plan="autotune",
                              **kw)
        assert exe.plan_source == "autotune"
        np.testing.assert_array_equal(
            exe.forward().numpy(), exe.forward(features=ds.features).numpy())

    def test_compile_budget_zero_reports_fallback(self):
        ds, spec = _setup()
        exe = runtime.compile(spec, ds, device="cpu", plan="autotune",
                              tune_budget=0, max_shard_n=64)
        assert exe.plan_source == "analytic_fallback"
        assert "autotune: analytic fallback" in exe.summary()
        assert exe.forward().shape == (ds.profile.num_nodes,
                                       ds.profile.num_classes)

    def test_compile_rejects_unknown_plan_source(self):
        ds, spec = _setup()
        with pytest.raises(ValueError, match="plan must be"):
            runtime.compile(spec, ds, device="cpu", plan="magic")


@pytest.mark.parametrize("arch", ARCHS)
def test_autotuned_matches_reference(arch):
    """The tuner changes only how a layer runs: the port's autotuned
    compile gives the JAX reference's analytic logits on the same graph
    and parameters."""
    ds = make_dataset("citeseer", seed=1, scale=SCALES["citeseer"] * 2)
    spec = ZooSpec(arch, ds.profile.feature_dim, 8, ds.profile.num_classes)
    params = jax.tree_util.tree_map(
        np.asarray, init_zoo(jax.random.key(0), _jax_spec(spec)))
    want = np.asarray(jax_runtime.compile(
        _jax_spec(spec), jax_make_dataset("citeseer", seed=1,
                                          scale=SCALES["citeseer"] * 2),
        backend="reference", params=params, max_shard_n=16).forward())
    tuned = runtime.compile(spec, ds, device="cpu", params=params,
                            plan="autotune", tune_budget=3, tune_reps=1,
                            max_shard_n=16)
    assert tuned.plan_source == "autotune"
    assert tuned.tune_report["candidates_failed"] == 0
    np.testing.assert_allclose(tuned.forward().numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# the API surface
# ---------------------------------------------------------------------------

def test_fit_autotune_trains_the_tuned_plan():
    ds, spec = _setup(scale=0.1)
    res = runtime.fit(spec, ds, steps=6, lr=1e-2, device="cpu",
                      max_shard_n=64, plan="autotune", tune_budget=3,
                      log_every=1, log=lambda line: None)
    exe = res.executable
    assert exe.plan_source == "autotune"
    assert exe.tune_report["candidates_measured"] >= 1
    losses = [loss for _, loss in res.history]
    assert len(losses) == 6 and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="plan must be"):
        runtime.fit(spec, ds, steps=1, device="cpu", plan="magic",
                    log=lambda line: None)


def test_gnn_serve_engine_autotune():
    from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest

    ds, _ = _setup(scale=0.05)
    prof = ds.profile
    engine = GNNServeEngine(device="cpu", max_shard_n=64, plan="autotune",
                            tune_budget=3)
    engine.register_graph("cora", ds)
    for arch in ("gcn", "sage_max"):
        engine.register_model(arch, ZooSpec(arch, prof.feature_dim, 8,
                                            prof.num_classes), seed=0)
    for arch in ("gcn", "sage_max"):
        (pred,) = engine.step((arch, "cora"), [
            NodeRequest("cora", np.array([0, 3, 7]), model=arch)])
        assert pred.classes.shape == (3,)
        exe = engine.executable(arch, "cora")
        assert exe.plan_source == "autotune"
        assert exe.tune_report["candidates_failed"] == 0
    with pytest.raises(ValueError, match="plan must be"):
        GNNServeEngine(device="cpu", plan="magic")


def test_launchers_plan_autotune(capsys, tmp_path, monkeypatch):
    from repro_torch.launch import serve, train_gnn

    monkeypatch.setenv("REPRO_PLAN_CACHE", str(tmp_path))
    serve.main(["--mode", "gnn", "--device", "cpu", "--graphs", "cora",
                "--scale", "0.05", "--shard-n", "64", "--num-requests", "6",
                "--models", "gcn,gin", "--plan", "autotune",
                "--tune-budget", "3"])
    out = capsys.readouterr().out
    assert "plan source: autotune (budget 3 candidates" in out
    assert "served 6/6 requests" in out
    assert len(list(tmp_path.glob("tune-*.json"))) == 2
    train_gnn.main(["--device", "cpu", "--dataset", "cora", "--arch", "gcn",
                    "--steps", "2", "--scale", "0.05", "--shard-n", "64",
                    "--plan", "autotune", "--tune-budget", "3",
                    "--log-every", "1"])
    out = capsys.readouterr().out
    assert "plan=autotune" in out and "autotune: winner" in out
