"""The port's Server + GNNServeEngine against the reference engine.

A fixed request trace through both servers, on the same graph and
parameters, must give the same classes; typed rejection and hot reload
follow the reference engine's contract.
"""
import jax
import numpy as np
import pytest
import torch

from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo
from repro.serving import Completed as JaxCompleted
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import Server as JaxServer
from repro.serving.gnn_engine import GNNServeEngine as JaxEngine
from repro.serving.gnn_engine import NodeRequest as JaxRequest
from repro_torch import runtime
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.serving import (Completed, GNNServeEngine, NodeRequest,
                                 Rejected, SchedulerConfig, Server)

ARCHS = ("gcn", "sage_mean", "sage_max")
SHARD_N = 64


@pytest.fixture(scope="module")
def cora():
    return make_dataset("cora", seed=0, scale=0.1)


def _jax_params(prof, arch, seed=0):
    spec = JaxSpec(arch, prof.feature_dim, 16, prof.num_classes)
    return jax.tree_util.tree_map(np.asarray,
                                  init_zoo(jax.random.key(seed), spec))


def _spec(prof, arch):
    return ZooSpec(arch, prof.feature_dim, 16, prof.num_classes)


def _trace(prof, n=18):
    rng = np.random.default_rng(7)
    return [(ARCHS[i % 3],
             rng.integers(0, prof.num_nodes, size=int(rng.integers(1, 9))))
            for i in range(n)]


def _engine(cora, **kw):
    engine = GNNServeEngine(device="cpu", max_shard_n=SHARD_N, **kw)
    engine.register_graph("cora", cora)
    return engine


def test_request_trace_matches_reference_engine(cora):
    prof = cora.profile
    params = {a: _jax_params(prof, a, seed=i) for i, a in enumerate(ARCHS)}
    jeng = JaxEngine(backend="reference", max_shard_n=SHARD_N)
    jeng.register_graph("cora", cora)
    eng = _engine(cora)
    for a in ARCHS:
        jeng.register_model(a, JaxSpec(a, prof.feature_dim, 16,
                                       prof.num_classes), params=params[a])
        eng.register_model(a, _spec(prof, a), params=params[a])
    jsrv = JaxServer(jeng, JaxSchedulerConfig(max_batch_size=4))
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    trace = _trace(prof)
    jt = [jsrv.submit(JaxRequest("cora", ids, a)) for a, ids in trace]
    tt = [srv.submit(NodeRequest("cora", ids, a)) for a, ids in trace]
    jsrv.drain()
    srv.drain()
    for j, t, (_, ids) in zip(jt, tt, trace):
        jo, to = j.result(), t.result()
        assert isinstance(jo, JaxCompleted) and isinstance(to, Completed)
        np.testing.assert_array_equal(to.value.node_ids, ids)
        np.testing.assert_array_equal(to.value.classes, jo.value.classes)
        np.testing.assert_allclose(to.value.probs, jo.value.probs,
                                   atol=1e-5, rtol=1e-5)
    assert eng.stats["compiles"] == 3
    assert eng.stats["graph_cache_misses"] == 3   # three signatures
    assert eng.stats["requests"] == len(trace)
    assert "3 executables compiled" in eng.cache_report()


@pytest.mark.parametrize("request_kw,match", [
    (dict(model="nope"), "unknown model"),
    (dict(graph="nope"), "unknown graph"),
    (dict(node_ids=np.array([10_000])), "out of range"),
])
def test_bad_requests_are_rejected_typed(cora, request_kw, match):
    eng = _engine(cora)
    eng.register_model("gcn", _spec(cora.profile, "gcn"))
    srv = Server(eng)
    req = dict(graph="cora", node_ids=np.arange(3), model="gcn")
    req.update(request_kw)
    out = srv.submit(NodeRequest(**req)).result()
    assert isinstance(out, Rejected) and out.kind == "invalid"
    assert match in out.reason
    assert eng.stats["compiles"] == 0


def test_unported_arch_is_rejected_typed(cora):
    """gin was the unported arch this test rejected; it is served now,
    beside gcn, and the typed rejection is held on a model the engine
    does not know."""
    eng = _engine(cora)
    eng.register_model("gcn", _spec(cora.profile, "gcn"))
    eng.register_model("gin", _spec(cora.profile, "gin"))
    srv = Server(eng)
    bad = srv.submit(NodeRequest("cora", np.arange(3), "gat"))
    gin = srv.submit(NodeRequest("cora", np.arange(3), "gin"))
    good = srv.submit(NodeRequest("cora", np.arange(3), "gcn"))
    assert isinstance(bad.result(), Rejected)
    assert "unknown model" in bad.result().reason
    assert isinstance(gin.result(), Completed)
    assert isinstance(good.result(), Completed)


def test_reload_params_invalidates_once_and_serves_new_weights(cora):
    prof = cora.profile
    eng = _engine(cora)
    eng.register_model("gcn", _spec(prof, "gcn"),
                       params=_jax_params(prof, "gcn", seed=0))
    srv = Server(eng)
    ids = np.arange(0, prof.num_nodes, 5)
    first = srv.submit(NodeRequest("cora", ids, "gcn")).result()
    exe = eng.executable("gcn", "cora")
    assert exe.has_cached_probs

    new = _jax_params(prof, "gcn", seed=9)
    assert srv.reload(lambda e: e.reload_params("gcn", new)) == 1
    assert eng.stats["reloads"] == 1
    assert eng.stats["logits_invalidations"] == 1
    assert not exe.has_cached_probs
    assert eng.stats["compiles"] == 1          # no recompile

    after = srv.submit(NodeRequest("cora", ids, "gcn")).result()
    fresh = runtime.compile(_spec(prof, "gcn"), cora, device="cpu",
                            params=new, max_shard_n=SHARD_N)
    np.testing.assert_array_equal(after.value.classes,
                                  fresh.predict(ids)[0])
    assert isinstance(first, Completed) and isinstance(after, Completed)

    with pytest.raises(ValueError, match="rejected"):
        eng.reload_params("gcn", _jax_params(prof, "sage_mean"))
    assert eng.stats["reloads"] == 1           # all-or-nothing


def test_reload_does_not_fail_inflight_cobatched_requests(cora):
    """Requests queued before a reload, co-batched on one stream, all
    complete (on the new weights: the reload runs before they dispatch)."""
    prof = cora.profile
    eng = _engine(cora)
    eng.register_model("gcn", _spec(prof, "gcn"))
    srv = Server(eng, SchedulerConfig(max_batch_size=8))
    rng = np.random.default_rng(0)
    tickets = [srv.submit(NodeRequest(
        "cora", rng.integers(0, prof.num_nodes, 4), "gcn"))
        for _ in range(6)]
    assert srv.queue_depth() == 6
    new = _jax_params(prof, "gcn", seed=7)
    srv.reload(lambda e: e.reload_params("gcn", new))
    srv.drain()
    outs = [t.result() for t in tickets]
    assert all(isinstance(o, Completed) for o in outs), outs
    m = srv.metrics()
    assert m["failed"] == 0 and m["reloads"] == 1 and m["batches"] == 1
    fresh = runtime.compile(_spec(prof, "gcn"), cora, device="cpu",
                            params=new, max_shard_n=SHARD_N)
    for t, o in zip(tickets, outs):
        np.testing.assert_array_equal(o.value.classes,
                                      fresh.predict(o.value.node_ids)[0])


def test_reload_validation_is_atomic(cora):
    prof = cora.profile
    eng = _engine(cora)
    eng.register_model("gcn", _spec(prof, "gcn"))
    srv = Server(eng)
    t = srv.submit(NodeRequest("cora", np.arange(3), "gcn"))
    srv.drain()
    assert isinstance(t.result(), Completed)
    exe = eng.executable("gcn", "cora")
    before = {k: v.clone() for k, v in exe.params["layers"][0].items()}

    wrong = JaxSpec("gcn", prof.feature_dim, 12, prof.num_classes)
    with pytest.raises(ValueError, match="reload"):
        srv.reload(lambda e: e.reload_params(
            "gcn", jax.tree_util.tree_map(
                np.asarray, init_zoo(jax.random.key(0), wrong))))
    # nothing was touched: cache still warm, params unchanged
    assert exe.has_cached_probs
    assert eng.stats["reloads"] == 0
    assert eng.stats["logits_invalidations"] == 0
    assert all(torch.equal(exe.params["layers"][0][k], v)
               for k, v in before.items())
    assert srv.metrics()["reloads"] == 0
    with pytest.raises(KeyError):
        srv.reload(lambda e: e.reload_params("nope", {}))


def test_engine_serve_keeps_request_order(cora):
    prof = cora.profile
    eng = _engine(cora)
    for a in ARCHS:
        eng.register_model(a, _spec(prof, a))
    trace = _trace(prof, n=6)
    preds = eng.serve([NodeRequest("cora", ids, a) for a, ids in trace])
    assert [p.model for p in preds] == [a for a, _ in trace]
    for p, (_, ids) in zip(preds, trace):
        np.testing.assert_array_equal(p.node_ids, ids)


def test_register_graph_refuses_oversized_densification(cora):
    eng = GNNServeEngine(device="cpu", max_shard_n=SHARD_N,
                         max_dense_gib=1e-6)
    with pytest.raises(ValueError, match="densify"):
        eng.register_graph("cora", cora)
