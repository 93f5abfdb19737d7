"""The port's streaming graphs against the reference package.

The host code (``graphs/delta.py``, ``stream/workload.py``, the numpy
part of ``graphs/patch.py``) is held bitwise to ``repro``'s on the same
inputs; the device part is held to a fresh build: a patch is
copy-on-write (the previous ``GraphTensors`` and its kept CSR indexes
are never touched) and the patched tensors' indexes equal a from-scratch
build's. Every arch keeps its Executable through in-template deltas and
then computes what a fresh compile computes, bitwise, and what the
reference Executable driven through the same deltas computes, within
1e-4. The serving engines of both packages, given the same deltas and
requests, serve the same classes and count the same invalidations; the
stream trainer's first loss matches the reference's within 1e-5.

The reference's ``test_mutation_oracle_*`` tests drive ``repro.analyze``
(the RT003 mutation oracle), which is not ported yet: ROADMAP.md Queue 1
item 6.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import runtime as jruntime
from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo
from repro.graphs import delta as jdelta
from repro.graphs.datasets import make_dataset as jax_make_dataset
from repro.graphs.patch import PatchState as JaxPatchState
from repro.runtime.api import graph_fingerprint as jax_fingerprint
from repro.runtime.fit import TrainableExecutable as JaxTrainable
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import Server as JaxServer
from repro.serving.gnn_engine import GNNServeEngine as JaxEngine
from repro.serving.gnn_engine import NodeRequest as JaxRequest
from repro.graphs.sampler import NeighborSampler as JaxSampler
from repro.stream import StreamTrainer as JaxStreamTrainer
from repro.stream import random_delta as jax_random_delta
from repro_torch import runtime
from repro_torch.core.engines import GraphTensors
from repro_torch.gnn.models import ARCHS, ZooSpec, graph_signature
from repro_torch.graphs import (GraphDelta, PatchState, apply_to_graph_data,
                                delta as tdelta)
from repro_torch.graphs.datasets import make_dataset
from repro_torch.graphs.patch import fullest_pair_insert
from repro_torch.graphs.sampler import NeighborSampler
from repro_torch.kernels import csr
from repro_torch.runtime.api import graph_fingerprint
from repro_torch.runtime.forward import build_graph_tensors
from repro_torch.serving import Completed, SchedulerConfig, Server
from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest
from repro_torch.stream import StreamTrainer, random_delta

SHARD_N = 64
QUIET = dict(log=lambda s: None)
# the four graph signatures of the zoo: (gcn, loops), (mean, loops),
# (sum, loops) for sage_max and gat, (sum, no loops) for gin
SIG_ARCHS = ("gcn", "sage_mean", "sage_max", "gin")


def _ds(scale=0.05, seed=0):
    return make_dataset("cora", seed=seed, scale=scale)


def _jds(scale=0.05, seed=0):
    return jax_make_dataset("cora", seed=seed, scale=scale)


def _specs(prof, arch, hidden=8):
    args = (arch, prof.feature_dim, hidden, prof.num_classes)
    return ZooSpec(*args, num_layers=2, heads=2), \
        JaxSpec(*args, num_layers=2, heads=2)


def _jax_params(jspec, seed=0):
    return jax.tree_util.tree_map(np.asarray,
                                  init_zoo(jax.random.key(seed), jspec))


def _deltas(ds, seed, k, **kw):
    """Yield ``k`` deltas drawn from one seeded stream against ``ds``,
    each with ``ds``'s (edges, num_nodes) before it; ``ds`` is already
    mutated by the delta when it is yielded."""
    rng = np.random.default_rng(seed)
    for _ in range(k):
        before = (ds.edges.copy(), ds.profile.num_nodes)
        d = random_delta(ds, rng, **kw)
        apply_to_graph_data(ds, d)
        yield d, before


def _as_jax_delta(d: GraphDelta) -> jdelta.GraphDelta:
    return jdelta.GraphDelta(
        add_edges=d.add_edges, del_edges=d.del_edges, add_nodes=d.add_nodes,
        add_features=d.add_features, add_labels=d.add_labels,
        del_nodes=d.del_nodes)


def _assert_deltas_equal(a, b):
    for f in dataclasses.fields(GraphDelta):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            assert x is None and y is None, f.name
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)


# --------------------------------------------------------------------------
# host code: bitwise to the reference
# --------------------------------------------------------------------------

@given(seed=st.integers(min_value=0, max_value=9999),
       p_node=st.sampled_from([0.0, 0.5]))
@settings(max_examples=6, deadline=None)
def test_random_delta_draws_the_reference_deltas(seed, p_node):
    ds, jds = _ds(), _jds()
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        d = random_delta(ds, rng, edge_ops=8, p_node=p_node,
                         max_new_nodes=2)
        jd = jax_random_delta(jds, jrng, edge_ops=8, p_node=p_node,
                              max_new_nodes=2)
        _assert_deltas_equal(d, jd)
        apply_to_graph_data(ds, d)
        jdelta.apply_to_graph_data(jds, jd)
        assert ds.version == jds.version
    # both generators were drawn from in the same order
    assert rng.random() == jrng.random()


@given(seed=st.integers(min_value=0, max_value=9999),
       with_nodes=st.booleans())
@settings(max_examples=6, deadline=None)
def test_delta_math_is_bitwise_the_reference(seed, with_nodes):
    ds = _ds()
    for d, (edges, num) in _deltas(ds, seed, 5, edge_ops=8,
                                   p_node=0.5 if with_nodes else 0.0,
                                   max_new_nodes=2):
        jd = _as_jax_delta(d)
        np.testing.assert_array_equal(tdelta.removed_edge_mask(edges, d),
                                      jdelta.removed_edge_mask(edges, jd))
        after, n_after = tdelta.apply_to_edge_list(edges, num, d)
        jafter, jn_after = jdelta.apply_to_edge_list(edges, num, jd)
        assert n_after == jn_after
        assert after.dtype == jafter.dtype
        np.testing.assert_array_equal(after, jafter)
        np.testing.assert_array_equal(tdelta.touched_nodes(d, edges, num),
                                      jdelta.touched_nodes(jd, edges, num))
        for norm in ("gcn", "mean", "sum"):
            seeds = tdelta.seed_nodes(d, edges, after, num, norm)
            np.testing.assert_array_equal(
                seeds, jdelta.seed_nodes(jd, edges, after, num, norm))
            for hops in (0, 1, 2):
                np.testing.assert_array_equal(
                    tdelta.affected_nodes(after, seeds, hops, n_after),
                    jdelta.affected_nodes(after, seeds, hops, n_after))


def test_delta_errors_match_the_reference():
    ds = _ds()
    e, n = ds.edges, ds.profile.num_nodes
    present = set(map(tuple, e.tolist()))
    missing = next((u, v) for u in range(n) for v in range(n)
                   if u != v and (u, v) not in present)
    for kw in (dict(del_edges=[missing]), dict(del_nodes=[n]),
               dict(add_edges=[[0, n + 1]], add_nodes=1),
               dict(del_edges=[[-1, 0]])):
        with pytest.raises(ValueError) as ours:
            tdelta.apply_to_edge_list(e, n, GraphDelta(**kw))
        with pytest.raises(ValueError) as theirs:
            jdelta.apply_to_edge_list(e, n, jdelta.GraphDelta(**kw))
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="no such edge"):
        tdelta.removed_edge_mask(e, GraphDelta(del_edges=[missing]))
    # a raising delta leaves the graph untouched
    before = ds.edges.copy()
    with pytest.raises(ValueError):
        apply_to_graph_data(ds, GraphDelta(add_nodes=1))  # no features
    np.testing.assert_array_equal(ds.edges, before)
    assert ds.version == 0


def test_delta_on_a_full_scale_dataset_leaves_the_profile_table():
    """A full-scale GraphData owns its profile: a delta that adds nodes
    grows that graph's profile, never the module's table, so a later
    ``make_dataset`` of the same name is the published graph again."""
    from repro_torch.graphs.datasets import DATASETS, make_dataset

    ds = make_dataset("cora", seed=0)
    n0, e0 = DATASETS["cora"].num_nodes, DATASETS["cora"].num_edges
    apply_to_graph_data(ds, GraphDelta(
        add_nodes=2, add_features=ds.features[:2], add_labels=ds.labels[:2],
        add_edges=[[n0, 0], [n0 + 1, 1]]))
    assert ds.profile.num_nodes == n0 + 2
    assert (DATASETS["cora"].num_nodes, DATASETS["cora"].num_edges) == \
        (n0, e0)
    assert make_dataset("cora", seed=0).profile.num_nodes == n0


_PATCH_FIELDS = ("edges", "num_nodes", "S", "e_cap", "blocks", "edge_src",
                 "edge_dst", "edge_valid", "counts", "deg_in", "deg_out")


def _assert_patch_states_equal(ps, jps):
    for name in _PATCH_FIELDS:
        a, b = getattr(ps, name), getattr(jps, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_results_equal(res, jres):
    for f in dataclasses.fields(res):
        if f.name in ("apply_ms", "pairs"):
            continue
        assert getattr(res, f.name) == getattr(jres, f.name), f.name
    if res.pairs is None:
        assert jres.pairs is None
    else:
        for a, b in zip(res.pairs, jres.pairs):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_nodes", [False, True])
@pytest.mark.parametrize("arch", SIG_ARCHS)
def test_patch_state_is_bitwise_the_reference(arch, with_nodes):
    ds = _ds()
    ps = PatchState.for_arch(ds.edges, ds.profile.num_nodes, 32, arch)
    jps = JaxPatchState.for_arch(ds.edges, ds.profile.num_nodes, 32, arch)
    _assert_patch_states_equal(ps, jps)
    for d, _ in _deltas(ds, 11, 6, edge_ops=8,
                        p_node=0.5 if with_nodes else 0.0, max_new_nodes=2):
        res, jres = ps.apply(d), jps.apply(_as_jax_delta(d))
        _assert_results_equal(res, jres)
        _assert_patch_states_equal(ps, jps)
        ps.verify_against_rebuild()
        assert ps.num_nodes == ds.profile.num_nodes
        np.testing.assert_array_equal(ps.edges, ds.edges)


def test_pair_rows_is_the_reference():
    from repro.graphs.patch import pair_rows as jax_pair_rows
    from repro_torch.graphs.patch import pair_rows

    ds = _ds()
    ps = PatchState.for_arch(ds.edges, ds.profile.num_nodes, 32, "gcn")
    for d, _ in _deltas(ds, 8, 3, edge_ops=8, p_node=0.5):
        res = ps.apply(d)
        np.testing.assert_array_equal(
            pair_rows(res.pairs, 32, ps.num_nodes),
            jax_pair_rows(res.pairs, 32, ps.num_nodes))
    assert pair_rows(None, 32, ps.num_nodes) is None


def test_patch_compaction_reasons_match_the_reference():
    ds = _ds()
    num = ds.profile.num_nodes
    ps = PatchState(ds.edges, num, 32, slack=0.0)
    jps = JaxPatchState(ds.edges, num, 32, slack=0.0)
    d = fullest_pair_insert(ps)
    res, jres = ps.apply(d), jps.apply(_as_jax_delta(d))
    assert res.rebuilt and res.reason == "edge-capacity"
    _assert_results_equal(res, jres)
    _assert_patch_states_equal(ps, jps)
    ps.verify_against_rebuild()

    spare = ps.S * ps.n - ps.num_nodes
    k = spare + 3
    feats = np.zeros((k, ds.features.shape[1]), np.float32)
    grow = GraphDelta(add_nodes=k, add_features=feats,
                      add_edges=[[ps.num_nodes + i, i] for i in range(k)])
    res, jres = ps.apply(grow), jps.apply(_as_jax_delta(grow))
    assert res.rebuilt and res.reason == "node-capacity"
    assert res.shards_total > (ps.S - 1) ** 2
    _assert_results_equal(res, jres)
    _assert_patch_states_equal(ps, jps)
    ps.verify_against_rebuild()


# --------------------------------------------------------------------------
# device part: copy-on-write, indexes built afresh
# --------------------------------------------------------------------------

def _snapshot(gt: GraphTensors) -> dict:
    return {name: getattr(gt, name).clone()
            for name in ("blocks", "edge_src", "edge_dst", "edge_valid")}


def _assert_same_index(a, b):
    for name in a.__dataclass_fields__:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("arch", SIG_ARCHS)
def test_to_graph_tensors_is_copy_on_write(arch):
    ds = _ds()
    ps = PatchState.for_arch(ds.edges, ds.profile.num_nodes, 32, arch)
    gt0 = ps.to_graph_tensors(device="cpu")
    lin0, gat0 = gt0.linear_index, gt0.gather_index   # kept on gt0
    snap = _snapshot(gt0)
    prev = gt0
    for d, _ in _deltas(ds, 5, 3, edge_ops=8, p_node=0.5):
        res = ps.apply(d)
        assert not res.rebuilt
        gt = ps.to_graph_tensors(prev=prev, pairs=res.pairs)
        assert gt is not prev
        assert gt.blocks.data_ptr() != prev.blocks.data_ptr()
        assert gt.num_nodes == ds.profile.num_nodes
        prev = gt
    # the first object and its kept indexes are exactly as they were
    for name, t in snap.items():
        assert torch.equal(getattr(gt0, name), t), name
    assert gt0.linear_index is lin0 and gt0.gather_index is gat0
    _assert_same_index(lin0, csr.linear_index(snap["blocks"]))
    # the patched object's indexes equal a from-scratch build's
    fresh = build_graph_tensors(ds.edges, ds.profile.num_nodes, 32, arch,
                                "cpu")
    assert torch.equal(prev.blocks, fresh.blocks)
    _assert_same_index(prev.linear_index, fresh.linear_index)
    _assert_same_index(prev.gather_index, fresh.gather_index)
    assert not prev.blocks.is_inference()


def test_full_upload_does_not_alias_the_host_mirror():
    ds = _ds()
    ps = PatchState.for_arch(ds.edges, ds.profile.num_nodes, 32, "gcn")
    gt = ps.to_graph_tensors(device="cpu")
    snap = _snapshot(gt)
    for d, _ in _deltas(ds, 2, 2, edge_ops=8):
        ps.apply(d)
    for name, t in snap.items():
        assert torch.equal(getattr(gt, name), t), name


def test_to_graph_tensors_without_prev_needs_a_device():
    ds = _ds()
    ps = PatchState.for_arch(ds.edges, ds.profile.num_nodes, 32, "gcn")
    with pytest.raises(ValueError, match="device"):
        ps.to_graph_tensors()
    assert ps.to_graph_tensors(device="cpu").blocks.device.type == "cpu"


def test_to_graph_tensors_in_inference_mode_makes_normal_tensors():
    ds = _ds()
    ps = PatchState.for_arch(ds.edges, ds.profile.num_nodes, 32, "gcn")
    gt0 = ps.to_graph_tensors(device="cpu")
    ((d, _),) = _deltas(ds, 3, 1, edge_ops=8)
    res = ps.apply(d)
    with torch.inference_mode():
        gt = ps.to_graph_tensors(prev=gt0, pairs=res.pairs)
    assert not any(getattr(gt, k).is_inference() for k in _snapshot(gt))


# --------------------------------------------------------------------------
# versioned keys
# --------------------------------------------------------------------------

def test_fingerprint_folds_version_like_the_reference():
    ds = _ds()
    args = (ds.edges, ds.profile.num_nodes, ds.features)
    for v in (0, 1, 7):
        assert graph_fingerprint(*args, version=v) == \
            jax_fingerprint(*args, version=v)
    assert graph_fingerprint(*args, version=0) != \
        graph_fingerprint(*args, version=1)
    assert graph_fingerprint(*args) == graph_fingerprint(*args, version=0)


def test_versioned_store_never_returns_a_pre_delta_build():
    ds = _ds()
    store = runtime.GraphStore()
    num = ds.profile.num_nodes
    kw = dict(device=torch.device("cpu"))
    e0 = store.get("g", ds.edges, num, 32, "gcn", ds.features, version=0,
                   mutable=True, **kw)
    imm = store.get("g", ds.edges, num, 32, "sage_mean", version=0, **kw)
    assert imm.patch_state is None
    # a mutable request on the immutable entry rebuilds it mutable
    assert store.get("g", ds.edges, num, 32, "sage_mean", version=0,
                     mutable=True, **kw).patch_state is not None
    store.get("g", ds.edges, num, 32, "gin", version=0, **kw)  # immutable
    gt0 = e0.gt
    ((d, _),) = _deltas(ds, 4, 1, edge_ops=8)
    out = store.patch("g", d, old_version=0, new_version=1)
    assert set(out) == {("gcn", True, 32, "cpu"), ("mean", True, 32, "cpu")}
    assert store.stats["patches"] == 2 and store.stats["patch_drops"] == 1
    assert len(store) == 2
    e1 = store.get("g", ds.edges, num, 32, "gcn", version=1, mutable=True,
                   **kw)
    assert e1 is e0 and e1.version == 1 and e1.gt is not gt0
    hits = store.stats["hits"]
    # the pre-delta key is gone: a v0 request misses and rebuilds
    stale = store.get("g", ds.edges, num, 32, "gcn", version=0, **kw)
    assert store.stats["hits"] == hits and stale is not e1
    # an invalid delta leaves the store untouched
    bad = GraphDelta(del_edges=[[0, 0]])
    with pytest.raises(ValueError):
        store.patch("g", bad, old_version=1, new_version=2)
    assert store.get("g", ds.edges, num, 32, "gcn", version=1, mutable=True,
                     **kw) is e1


# --------------------------------------------------------------------------
# every arch: no recompile, fresh-compile bitwise, reference within 1e-4
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_mutation_keeps_the_executable_and_matches(arch):
    ds, jds = _ds(), _jds()
    spec, jspec = _specs(ds.profile, arch)
    params = _jax_params(jspec)
    store, jstore = runtime.GraphStore(), jruntime.GraphStore()
    exe = runtime.compile(spec, ds, device="cpu", params=params,
                          max_shard_n=SHARD_N, store=store, graph_key="g",
                          mutable_graph=True)
    jexe = jruntime.compile(jspec, jds, backend="reference", params=params,
                            max_shard_n=SHARD_N, store=jstore,
                            graph_key="g", mutable_graph=True)
    exe.forward()
    plan, p0 = exe.plan, exe.params
    norm, loops = graph_signature(arch)
    for d, _ in _deltas(ds, 1, 3, edge_ops=6):       # edge churn only
        old_v = jds.version                          # ds is one ahead
        jd = _as_jax_delta(d)
        jdelta.apply_to_graph_data(jds, jd)
        hit = store.patch("g", d, old_version=old_v,
                          new_version=ds.version)[
                              (norm, loops, exe.plan.shard_n, "cpu")]
        jhit = jstore.patch("g", jd, old_version=old_v,
                            new_version=jds.version)[
                                (norm, loops, jexe.plan.shard_n)]
        entry, res = hit
        assert not res.rebuilt     # slack absorbs these small deltas
        exe.update_graph(entry.gt, entry.h_grouped)
        jexe.update_graph(jhit[0].gt, jhit[0].h_grouped)
    assert exe.plan is plan and exe.params is p0
    out = exe.forward()
    fresh = runtime.compile(spec, ds, device="cpu", params=params,
                            max_shard_n=SHARD_N)
    assert fresh.plan.shard_n == exe.plan.shard_n
    assert torch.equal(out, fresh.forward())
    np.testing.assert_allclose(out.numpy(), np.asarray(jexe.forward()),
                               atol=1e-4, rtol=1e-4)


def test_update_graph_refuses_a_template_break():
    ds = _ds()
    spec, _ = _specs(ds.profile, "gcn")
    exe = runtime.compile(spec, ds, device="cpu", max_shard_n=SHARD_N,
                          mutable_graph=True)
    other = runtime.compile(spec, ds, device="cpu", max_shard_n=SHARD_N)
    gt = exe.gt
    # the immutable build has no slack slots: another edge-list shape
    with pytest.raises(ValueError, match="template break"):
        exe.update_graph(other.gt)
    with pytest.raises(ValueError, match="feature template"):
        exe.update_graph(gt, exe._h_grouped[:, :, :3])
    assert exe.gt is gt
    exe.predict([0, 1])
    assert exe.update_graph(gt, stale_nodes=[0, 0, 5]) == 2
    assert not exe.probs_fresh_for([0]) and exe.probs_fresh_for([1])
    assert exe.backend_name == "cuda" and exe.graph_version == 0


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _peripheral_edge(ds) -> np.ndarray:
    e = ds.edges
    deg = np.bincount(e.reshape(-1), minlength=ds.profile.num_nodes)
    k = int(np.argmin(deg[e[:, 0]] + deg[e[:, 1]]))
    return e[k:k + 1].copy()


@pytest.mark.parametrize("invalidation", ["targeted", "full"])
def test_streaming_engines_agree_with_the_reference(invalidation):
    ds, jds = _ds(scale=0.1), _jds(scale=0.1)
    models = ("gcn", "sage_max")
    eng = GNNServeEngine(device="cpu", max_shard_n=SHARD_N, streaming=True,
                         invalidation=invalidation)
    jeng = JaxEngine(backend="reference", max_shard_n=SHARD_N,
                     streaming=True, invalidation=invalidation)
    eng.register_graph("g", ds)
    jeng.register_graph("g", jds)
    for i, m in enumerate(models):
        spec, jspec = _specs(ds.profile, m)
        params = _jax_params(jspec, seed=i)
        eng.register_model(m, spec, params)
        jeng.register_model(m, jspec, params)
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    jsrv = JaxServer(jeng, JaxSchedulerConfig(max_batch_size=4))
    rng = np.random.default_rng(9)
    tickets, jtickets = [], []
    for _ in range(4):
        for m in models:
            ids = rng.integers(0, ds.profile.num_nodes, size=6)
            tickets.append(srv.submit(NodeRequest("g", ids, model=m)))
            jtickets.append(jsrv.submit(JaxRequest("g", ids, model=m)))
        srv.drain()
        jsrv.drain()
        d = random_delta(ds, rng, edge_ops=6, p_node=0.3)
        rep, jrep = srv.mutate("g", d), jsrv.mutate("g", _as_jax_delta(d))
        assert [(x["model"], x.get("rows_invalidated"))
                for x in rep["executables"]] == \
            [(x["model"], x.get("rows_invalidated"))
             for x in jrep["executables"]]
    srv.drain()
    jsrv.drain()
    for t, jt in zip(tickets, jtickets):
        out, jout = t.result(), jt.result()
        assert isinstance(out, Completed)
        np.testing.assert_array_equal(out.value.classes, jout.value.classes)
    s, js = eng.stats, jeng.stats
    for k in ("targeted_invalidations", "full_invalidations",
              "nodes_invalidated", "graph_recompiles", "graph_patches",
              "graph_patch_rebuilds", "mutations", "logits_cache_hits",
              "logits_cache_misses"):
        assert s[k] == js[k], k
    assert s["mutations"] == 4 and srv.metrics()["mutations"] == 4
    np.testing.assert_array_equal(eng.take_dirty("g"), jeng.take_dirty("g"))
    assert eng.take_dirty("g").size == 0


def test_targeted_invalidation_drops_a_minority_and_keeps_the_cache():
    ds = _ds()
    n = ds.profile.num_nodes
    eng = GNNServeEngine(device="cpu", max_shard_n=SHARD_N, streaming=True)
    eng.register_graph("g", ds)
    eng.register_model("gcn", _specs(ds.profile, "gcn")[0])
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    srv.submit(NodeRequest("g", np.arange(n), model="gcn"))
    srv.drain()
    rep = srv.mutate("g", GraphDelta(del_edges=_peripheral_edge(ds)))
    (m,) = rep["executables"]
    assert m["targeted"] and not m["recompile"]
    assert 0 < m["rows_invalidated"] < 0.5 * n and m["rows_cached"] == n
    exe = eng.executable("gcn", "g")
    assert exe.graph_version == 1 == eng.graph_version("g")
    assert exe.cached_rows == n         # a targeted invalidation keeps it
    stale = np.asarray(exe._stale)
    assert exe.probs_fresh_for(np.flatnonzero(~stale)[:4])
    assert not exe.probs_fresh_for(np.flatnonzero(stale)[:1])
    t = srv.submit(NodeRequest("g", np.flatnonzero(stale)[:1], model="gcn"))
    srv.drain()
    assert isinstance(t.result(), Completed)
    assert eng.stats["logits_cache_misses"] == 2 and exe._stale is None


def test_post_delta_predict_never_serves_stale_logits():
    ds = _ds(scale=0.1)
    spec = _specs(ds.profile, "gcn")[0]
    eng = GNNServeEngine(device="cpu", max_shard_n=SHARD_N, streaming=True)
    eng.register_graph("g", ds)
    eng.register_model("gcn", spec)
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    ids = np.arange(ds.profile.num_nodes)
    t = srv.submit(NodeRequest("g", ids, model="gcn"))
    srv.drain()
    before = t.result().value

    # rewire a hub: the served rows around it must change
    deg = np.bincount(ds.edges[:, 1], minlength=ds.profile.num_nodes)
    hub = int(np.argmax(deg))
    srv.mutate("g", GraphDelta(del_edges=ds.edges[ds.edges[:, 1] == hub]))
    t = srv.submit(NodeRequest("g", ids, model="gcn"))
    srv.drain()
    after = t.result().value

    fresh = runtime.compile(spec, ds, device="cpu", max_shard_n=SHARD_N,
                            params=eng.model_params("gcn"))
    want = torch.softmax(fresh.forward(), dim=-1).numpy()
    np.testing.assert_array_equal(after.classes, want.argmax(axis=-1))
    np.testing.assert_allclose(after.probs, want[ids, after.classes],
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(after.probs, before.probs)
    assert srv.metrics()["mutations"] == 1


def test_serving_continues_through_a_mutation_burst():
    ds = _ds()
    eng = GNNServeEngine(device="cpu", max_shard_n=SHARD_N, streaming=True)
    eng.register_graph("g", ds)
    eng.register_model("gcn", _specs(ds.profile, "gcn")[0])
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    rng = np.random.default_rng(3)
    tickets = []
    exe = None
    for _ in range(5):
        ids = rng.integers(0, ds.profile.num_nodes, size=6)
        tickets.append(srv.submit(NodeRequest("g", ids, model="gcn")))
        srv.drain()
        exe = exe or eng.executable("gcn", "g")
        srv.mutate("g", random_delta(ds, rng, edge_ops=4, p_node=0.3))
    srv.drain()
    assert all(isinstance(t.result(), Completed) for t in tickets)
    s = eng.stats
    assert s["graph_recompiles"] == 0 and s["mutations"] == 5
    assert s["compiles"] == 1 and eng.executable("gcn", "g") is exe


def test_server_mutate_requires_the_gnn_engine():
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.serving import ServeEngine

    cfg = get_smoke("qwen3-8b")
    eng = ServeEngine(cfg, lm.init_params(cfg, torch.Generator()
                                          .manual_seed(0)),
                      max_len=32, device="cpu")
    srv = Server(eng, SchedulerConfig(max_batch_size=2))
    with pytest.raises(TypeError, match="mutation"):
        srv.mutate("g", GraphDelta())
    assert srv.metrics()["mutations"] == 0


def test_compaction_drops_the_executable_and_recompiles_lazily():
    ds = _ds()
    eng = GNNServeEngine(device="cpu", max_shard_n=SHARD_N, streaming=True)
    eng.register_graph("g", ds)
    spec = _specs(ds.profile, "gcn")[0]
    eng.register_model("gcn", spec)
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    srv.submit(NodeRequest("g", [0, 1], model="gcn"))
    srv.drain()
    exe = eng.executable("gcn", "g")
    spare = exe.gt.S * exe.gt.n - ds.profile.num_nodes
    k = spare + 1
    n0 = ds.profile.num_nodes
    rep = srv.mutate("g", GraphDelta(
        add_nodes=k, add_features=ds.features[:k] * 0.5,
        add_labels=ds.labels[:k], add_edges=[[n0 + i, i] for i in range(k)]))
    assert rep["rebuilt"] and rep["executables"] == [
        {"model": "gcn", "recompile": True}]
    assert eng.stats["graph_recompiles"] == 1
    t = srv.submit(NodeRequest("g", [n0 + k - 1], model="gcn"))
    srv.drain()
    assert isinstance(t.result(), Completed)
    new = eng.executable("gcn", "g")
    assert new is not exe and new.gt.S == exe.gt.S + 1
    fresh = runtime.compile(spec, ds, device="cpu", max_shard_n=SHARD_N,
                            params=eng.model_params("gcn"))
    assert torch.equal(new.forward(), fresh.forward())


def test_dirty_log_loses_no_touched_node_under_concurrent_takes():
    """Mutations land through the Server on one thread while three
    trainer-like threads drain the dirty log: no touched node is lost
    (the log's read-union-write and its pop share one lock)."""
    import sys
    import threading

    ds = _ds()
    eng = GNNServeEngine(device="cpu", max_shard_n=SHARD_N, streaming=True)
    eng.register_graph("g", ds)
    eng.register_model("gcn", _specs(ds.profile, "gcn")[0])
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    replay = _ds()
    want = set()
    deltas = []
    for d, (edges, num) in _deltas(replay, 6, 30, edge_ops=4, p_node=0.2):
        deltas.append(d)
        want |= set(tdelta.touched_nodes(d, edges, num).tolist())
    taken, done = [], threading.Event()

    def take():
        while not done.is_set():
            taken.append(eng.take_dirty("g"))

    def mutate():
        for d in deltas:
            srv.mutate("g", d)
        done.set()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=take) for _ in range(3)]
        threads.append(threading.Thread(target=mutate))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    taken.append(eng.take_dirty("g"))
    assert set(np.concatenate(taken).tolist()) == want
    assert eng.stats["mutations"] == len(deltas)


# --------------------------------------------------------------------------
# training: update_sampler and the stream trainer
# --------------------------------------------------------------------------

def test_update_sampler_checks_the_template_and_matches_the_reference():
    ds, jds = _ds(scale=0.1), _jds(scale=0.1)
    spec, jspec = _specs(ds.profile, "gcn")
    params = _jax_params(jspec)
    num = ds.profile.num_nodes
    tm = np.flatnonzero(ds.train_mask)
    kw = dict(batch_nodes=8, fanout=(3, 2), seed_ids=tm, seed=0)
    exe = runtime.compile(spec, ds, device="cpu", params=params,
                          max_shard_n=SHARD_N)
    jexe = jruntime.compile(jspec, jds, backend="reference", params=params,
                            max_shard_n=SHARD_N)
    tr = runtime.TrainableExecutable(
        exe, ds.labels, train_mask=ds.train_mask, features=ds.features,
        sampler=NeighborSampler(ds.edges, num, **kw))
    jtr = JaxTrainable(jexe, jds.labels, train_mask=jds.train_mask,
                       features=jds.features,
                       sampler=JaxSampler(jds.edges, num, **kw))
    before = (tr.sampler, tr._mb, tr._mb_shape)
    with pytest.raises(ValueError, match="template mismatch"):
        tr.update_sampler(NeighborSampler(ds.edges, num, batch_nodes=8,
                                          fanout=(3, 3), seed_ids=tm))
    assert (tr.sampler, tr._mb, tr._mb_shape) == before
    budget = tr.sampler.budget
    with pytest.raises(ValueError, match="rebuild"):
        # a plan limit the template cannot keep: all-or-nothing rollback
        exe.gt = dataclasses.replace(exe.gt, n=2)
        try:
            tr.update_sampler(NeighborSampler(ds.edges, num, **kw))
        finally:
            exe.gt = dataclasses.replace(exe.gt, n=jexe.gt.n)
    assert (tr.sampler, tr._mb, tr._mb_shape) == before

    pool = tm[:40]
    new_kw = dict(kw, seed_ids=pool, seed=3, budget=budget)
    tr.update_sampler(NeighborSampler(ds.edges, num, **new_kw),
                      features=ds.features * 2, labels=ds.labels)
    jtr.update_sampler(JaxSampler(jds.edges, num, **new_kw),
                       features=jds.features * 2, labels=jds.labels)
    assert tr._mb_shape == jtr._mb_shape
    for step in (0, 5):
        ours, theirs = tr.data(step), jtr.data(step)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _stream_pair(scale=0.1, **trainer_kw):
    ds = _ds(scale=scale)
    spec, jspec = _specs(ds.profile, "gcn")
    eng = GNNServeEngine(device="cpu", max_shard_n=SHARD_N, streaming=True)
    eng.register_graph("g", ds)
    eng.register_model("gcn", spec, _jax_params(jspec))
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    trainer = StreamTrainer(srv, graph="g", model="gcn", batch_nodes=16,
                            fanout=(4, 4), seed=0, **QUIET, **trainer_kw)
    return ds, jspec, eng, srv, trainer


def test_stream_trainer_first_loss_matches_the_reference():
    ds, jspec, eng, srv, trainer = _stream_pair(steps_per_round=1)
    jds = _jds(scale=0.1)
    jeng = JaxEngine(backend="reference", max_shard_n=SHARD_N,
                     streaming=True)
    jeng.register_graph("g", jds)
    jeng.register_model("gcn", jspec, _jax_params(jspec))
    jsrv = JaxServer(jeng, JaxSchedulerConfig(max_batch_size=4))
    jtrainer = JaxStreamTrainer(jsrv, graph="g", model="gcn",
                                batch_nodes=16, fanout=(4, 4),
                                steps_per_round=1, seed=0, **QUIET)
    rng = np.random.default_rng(2)
    for _ in range(2):
        d = random_delta(ds, rng, edge_ops=6)
        srv.mutate("g", d)
        jsrv.mutate("g", _as_jax_delta(d))
        rep, jrep = trainer.round(), jtrainer.round()
        assert rep["dirty_nodes"] == jrep["dirty_nodes"]
        assert rep["seed_pool"] == jrep["seed_pool"]
        assert abs(rep["loss"] - jrep["loss"]) <= 1e-5
        assert abs(rep["train_acc"] - jrep["train_acc"]) <= 1e-6


def test_stream_trainer_rounds_reuse_one_unit_and_reload_only_at_the_end():
    ds, _, eng, srv, trainer = _stream_pair(steps_per_round=3)
    rng = np.random.default_rng(2)
    srv.mutate("g", random_delta(ds, rng, edge_ops=6))
    assert not trainer.round()["skipped"]
    tr = trainer._trainable
    served0 = eng.model_params("gcn")
    snap = runtime.executable._flatten_params(served0)
    seen = {}
    real_reload = srv.reload

    def reload_checked(fn):
        # the round trained before this point: the weights the server
        # holds must still be the previous round's
        now = runtime.executable._flatten_params(eng.model_params("gcn"))
        seen["before_reload"] = all(np.array_equal(now[k], v)
                                    for k, v in snap.items())
        return real_reload(fn)

    srv.reload = reload_checked
    srv.mutate("g", random_delta(ds, rng, edge_ops=6, p_node=1.0))
    rep = trainer.round()
    assert not rep["skipped"] and rep["dirty_nodes"] > 0
    assert seen["before_reload"]
    assert trainer._trainable is tr        # one unit across rounds
    assert trainer.stats == {"rounds": 2, "rounds_skipped": 0, "steps": 6,
                             "reloads": 2, "rebuilds": 0}
    # the old served tensors were never written in place
    old = runtime.executable._flatten_params(served0)
    assert all(np.array_equal(old[k], v) for k, v in snap.items())
    # the reload put the trained weights into serving (as copies)
    served = runtime.executable._flatten_params(eng.model_params("gcn"))
    trained = runtime.executable._flatten_params(tr.params)
    assert all(np.array_equal(served[k], trained[k]) for k in trained)
    assert eng.model_params("gcn")["layers"][0]["w"] is not \
        tr.params["layers"][0]["w"]
    # nothing mutated since: the next round skips
    assert trainer.round()["skipped"]
    assert trainer.stats["rounds_skipped"] == 1
    assert 0.0 <= trainer.train_accuracy() <= 1.0


def test_serve_mutate_train_on_one_graph():
    """A serving forward runs in inference mode; the patched tensors it
    then reads (and the indexes it builds on them) must still be usable
    by a training step's backward on the same store entry."""
    ds, _, eng, srv, trainer = _stream_pair(steps_per_round=2)
    srv.submit(NodeRequest("g", [0, 1, 2], model="gcn"))
    srv.drain()
    rng = np.random.default_rng(4)
    with torch.inference_mode():
        srv.mutate("g", random_delta(ds, rng, edge_ops=6, p_node=1.0))
    t = srv.submit(NodeRequest("g", np.arange(ds.profile.num_nodes),
                               model="gcn"))
    srv.drain()
    assert isinstance(t.result(), Completed)
    exe = eng.executable("gcn", "g")
    assert not exe.gt.linear_index.val.is_inference()
    assert not exe._h_grouped.is_inference()
    tr = runtime.TrainableExecutable(exe, ds.labels,
                                     train_mask=ds.train_mask)
    loss, _, grads = tr.loss_and_grads(tr.params, tr.data(0))
    assert torch.isfinite(loss)
    assert not trainer.round()["skipped"]


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_stream_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import stream

    args = stream.parser().parse_args(
        ["--device", "cpu", "--scale", "0.1", "--shard-n", "64",
         "--mutations", "6", "--finetune-every", "3", "--steps", "2",
         "--requests-per-mutation", "2"])
    out = stream.run(args)
    assert out["ok"] and out["served"] == out["submitted"] == 12
    assert out["trainer_stats"]["rounds"] == 2
    assert out["engine_stats"]["mutations"] == 6
    assert "[stream] OK" in capsys.readouterr().out
    # on a mesh (data 2 x model 2 on the CPU) the same run serves sharded
    out = stream.run(stream.parser().parse_args(
        ["--device", "cpu", "--scale", "0.1", "--shard-n", "64",
         "--mutations", "2", "--finetune-every", "2", "--steps", "1",
         "--requests-per-mutation", "1", "--mesh", "4"]))
    assert out["ok"] and out["served"] == out["submitted"] == 2


def test_stream_launcher_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import stream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream.run(stream.parser().parse_args(["--scale", "0.05"]))
