"""Training in the port against the reference package.

Each piece gets the same numpy inputs as its counterpart in ``repro``:

- the gradient of each differentiable kernel op (the registry's
  ``_with_plain_vjp``: forward the wrapper, backward autograd of the
  plain version; sage_max's max: ``ref.seg_gather_max_vjp``, the
  reference's tie rule) against ``jax.grad`` through the reference's
  ``pallas`` backend (interpret mode; its backward differentiates the
  oracles), and at ties against ``jax.grad`` of its ``reference``
  backend;
- the whole model's gradient, every arch on generic and degenerate
  graphs, as tests/test_gnn_grad.py holds the reference's backends;
- AdamW and its schedules, the neighbor sampler (bitwise), the
  checkpoint manager and resume (bitwise), and ``fit``'s loss trajectory
  from identical parameters and batches, full-batch and mini-batch.

Tolerances: float32 gradients atol = rtol = 1e-5 for one op, 2e-4 for a
whole model (sums in other orders through two layers); the optimizer
1e-6 relative (the same float32 arithmetic, pow and cos from another
library); each step's gradient along the reference's trajectory atol
1e-6, rtol 1e-4; free-running losses 1e-3 relative over 8 steps (why in
``test_full_batch_trajectory_matches_reference_fit``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jax_runtime
from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo
from repro.graphs.sampler import NeighborSampler as JaxSampler
from repro.kernels.registry import get_backend
from repro.runtime.fit import masked_cross_entropy as jax_ce
from repro.training import optimizer as jopt
from repro_torch import runtime
from repro_torch.checkpoint import CheckpointManager
from repro_torch.gnn.models import ARCHS, ZooSpec, params_from_numpy
from repro_torch.graphs.datasets import make_dataset
from repro_torch.graphs.sampler import NeighborSampler
from repro_torch.kernels import csr
from repro_torch.kernels.registry import resolve
from repro_torch.runtime.fit import masked_cross_entropy
from repro_torch.training import optimizer as topt

OP_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=2e-4, rtol=2e-4)
QUIET = dict(log=lambda s: None)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bitwise_equal(a, b) -> bool:
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# each op's gradient against jax.grad through the Pallas backend
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pallas():
    return get_backend("pallas")


def _torch_grads(fn, cot, *inputs):
    xs = [_t(x).requires_grad_() for x in inputs]
    out = fn(*xs)
    return out, torch.autograd.grad(out, xs, _t(cot))


def _jax_grads(fn, cot, *inputs):
    out, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in inputs))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _assert_grads(torch_side, jax_side, tol=OP_TOL):
    (out, grads), (jout, jgrads) = torch_side, jax_side
    np.testing.assert_allclose(out.detach().numpy(), jout, **tol)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), jg, **tol)


def _blocks(r, s, n, density):
    a = (r.random((s, s, n, n)) < density) * r.random((s, s, n, n))
    a[0, 1] = 0.0                       # an empty shard pair
    return a.astype(np.float32)


@pytest.mark.parametrize("activation", ["none", "relu"])
@pytest.mark.parametrize("bias", [True, False])
def test_dense_matmul_grad(pallas, activation, bias):
    r = np.random.default_rng(1)
    x = r.standard_normal((24, 20)).astype(np.float32)
    w = r.standard_normal((20, 12)).astype(np.float32)
    b = r.standard_normal(12).astype(np.float32)
    cot = r.standard_normal((24, 12)).astype(np.float32)
    args = (x, w, b) if bias else (x, w)
    be = resolve("cuda")
    _assert_grads(
        _torch_grads(lambda *a: be.dense_matmul(*a, activation=activation),
                     cot, *args),
        _jax_grads(lambda *a: pallas.dense_matmul(*a, activation=activation),
                   cot, *args))


@pytest.mark.parametrize("kept_index", [True, False])
def test_graph_aggregate_grad(pallas, kept_index):
    r = np.random.default_rng(2)
    a = _blocks(r, 3, 8, 0.3)
    h = r.standard_normal((3, 8, 5)).astype(np.float32)
    cot = r.standard_normal((3, 8, 5)).astype(np.float32)
    index = csr.linear_index(_t(a)) if kept_index else None
    be = resolve("cuda")
    _assert_grads(
        _torch_grads(lambda h: be.graph_aggregate(_t(a), h, index=index),
                     cot, h),
        _jax_grads(lambda h: pallas.graph_aggregate(jnp.asarray(a), h),
                   cot, h))


@pytest.mark.parametrize("kept_index", [True, False])
def test_fused_aggregate_extract_grad(pallas, kept_index):
    r = np.random.default_rng(3)
    a = _blocks(r, 3, 8, 0.3)
    h = r.standard_normal((3, 8, 6)).astype(np.float32)
    w = r.standard_normal((6, 4)).astype(np.float32)
    cot = r.standard_normal((3, 8, 4)).astype(np.float32)
    index = csr.linear_index(_t(a)) if kept_index else None
    be = resolve("cuda")
    _assert_grads(
        _torch_grads(lambda h, w: be.fused_aggregate_extract(
            _t(a), h, w, activation="relu", index=index), cot, h, w),
        _jax_grads(lambda h, w: pallas.fused_aggregate_extract(
            jnp.asarray(a), h, w, activation="relu"), cot, h, w))


@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("kept_index", [True, False])
def test_gather_aggregate_grad(pallas, op, kept_index):
    """Random edge lists with duplicate edges (a source listed twice for
    one destination: a tie of max within one row, which both sides send
    to that one source) and a destination shard without edges."""
    r = np.random.default_rng(4)
    s, n, e = 3, 8, 12
    es = r.integers(0, n, (s, s, e)).astype(np.int32)
    ed = r.integers(0, n, (s, s, e)).astype(np.int32)
    ev = r.random((s, s, e)) < 0.7
    es[:, :, 1], ed[:, :, 1], ev[:, :, :2] = es[:, :, 0], ed[:, :, 0], True
    ev[2] = False
    h = r.standard_normal((s, n, 5)).astype(np.float32)
    cot = r.standard_normal((s, n, 5)).astype(np.float32)
    index = csr.gather_index(_t(es), _t(ed), _t(ev), n) if kept_index \
        else None
    be = resolve("cuda")
    _assert_grads(
        _torch_grads(lambda h: be.gather_aggregate(
            _t(es), _t(ed), _t(ev), h, op=op, index=index), cot, h),
        _jax_grads(lambda h: pallas.gather_aggregate(
            es, ed, ev, h, op=op), cot, h))


def _tie_case(name):
    """(edge_src, edge_dst, edge_valid, h) of shape (S, S, E) / (S, n, D)
    with ties at destination (shard 0, row 0)'s maximum."""
    s, n, e = 3, 2, 4
    es = np.zeros((s, s, e), np.int32)
    ed = np.zeros((s, s, e), np.int32)
    ev = np.zeros((s, s, e), bool)
    h = np.ones((s, n, 2), np.float32)
    if name == "three_sources":       # 2 sources in pair (0,0), 1 in (0,1)
        es[0, 0, 1] = 1
        ev[0, 0, :2] = ev[0, 1, 0] = True
    elif name == "within_and_across_pairs":
        es[0, 0, :2] = (0, 1)         # pair (0,0): two tied sources
        es[0, 2, :3] = (0, 1, 1)      # pair (0,2): two tied, one duplicate
        ev[0, 0, :2] = ev[0, 2, :3] = True
        es[0, 1, 0], ev[0, 1, 0] = 1, True   # pair (0,1): below the max
        h[1, 1] = 0.5
        ed[1, 1, :2], es[1, 1, :2], ev[1, 1, :2] = 1, (0, 1), True
        ev[2, 0, 0] = ev[2, 2, 0] = True     # another row, ties too
        h[2, 0, 1] = 3.0
    elif name == "zero_tie_beside_empty_pair":
        h[:] = 0.0                    # relu outputs: ties at 0
        h[1, 0, 1] = -1.0
        es[0, 0, :2] = (0, 1)
        ev[0, 0, :2] = ev[0, 2, 0] = True    # pair (0,1) is empty
        ev[1, 1, 0] = True            # a row whose max is in column 1 < 0
    elif name == "duplicate_edges":
        es[0, 0, :3] = (1, 1, 0)      # source (0,1) listed twice
        ev[0, 0, :3] = True
        es[0, 1, :2] = (0, 0)         # source (1,0) twice, another pair
        ev[0, 1, :2] = True
        es[0, 2, 0], ev[0, 2, 0] = 1, True   # and (2,1) once, a third
        h[0, 0] = 0.25                # (0,0) below the max
    return es, ed, ev, h


@pytest.mark.parametrize("case", ["three_sources", "within_and_across_pairs",
                                  "zero_tie_beside_empty_pair",
                                  "duplicate_edges"])
@pytest.mark.parametrize("backend,kept_index", [
    ("cuda", True), ("cuda", False), ("reference", False)])
def test_gather_max_ties_match_reference_grad(backend, kept_index, case):
    """Ties at a destination's maximum, within one shard pair and across
    pairs: the port's backward (``ref.seg_gather_max_vjp``) equals
    ``jax.grad`` of the reference, whose per-pair scatter-max splits a
    pair's share evenly and whose jnp.maximum fold over source shards
    halves at each tie (three sources, two in one pair: 1/4, 1/4, 1/2)."""
    es, ed, ev, h = _tie_case(case)
    cot = np.random.default_rng(11).standard_normal(h.shape).astype(
        np.float32)
    index = csr.gather_index(_t(es), _t(ed), _t(ev), h.shape[1]) \
        if kept_index else None
    be = resolve(backend)
    ours = _torch_grads(lambda h: be.gather_aggregate(
        _t(es), _t(ed), _t(ev), h, op="max", index=index), cot, h)
    _assert_grads(ours, _jax_grads(
        lambda h: get_backend("reference").gather_aggregate(
            es, ed, ev, h, op="max"), cot, h))
    if case == "three_sources":
        g = ours[1][0][..., 0].reshape(-1)[:3] / cot[0, 0, 0]
        np.testing.assert_allclose(g.numpy(), [0.25, 0.25, 0.5], **OP_TOL)


def test_graph_aggregate_indexed_grad(pallas):
    """gat's aggregation: the index's values (α) and h both get their
    gradient; held to the reference's product by the α grid, whose
    gradient is read at the index's entries."""
    r = np.random.default_rng(5)
    s, n = 3, 8
    a = _blocks(r, s, n, 0.3)
    index = csr.linear_index(_t(a))
    h = r.standard_normal((s, n, 4)).astype(np.float32)
    cot = r.standard_normal((s, n, 4)).astype(np.float32)
    val = r.random(index.val.numel()).astype(np.float32)
    be = resolve("cuda")

    def ours(val, h):
        return be.graph_aggregate_indexed(
            dataclasses.replace(index, val=val), h)

    out, (gval, gh) = _torch_grads(ours, cot, val, h)
    rows = csr.entry_rows(index).numpy()
    col = index.col.numpy()
    ii, vv, jj, uu = rows // n, rows % n, col // n, col % n
    grid = np.zeros_like(a)
    grid[ii, jj, vv, uu] = val
    jout, (jgrid, jgh) = _jax_grads(pallas.graph_aggregate, cot, grid, h)
    np.testing.assert_allclose(out.detach().numpy(), jout, **OP_TOL)
    np.testing.assert_allclose(gh.numpy(), jgh, **OP_TOL)
    np.testing.assert_allclose(gval.numpy(), jgrid[ii, jj, vv, uu],
                               **OP_TOL)


# ---------------------------------------------------------------------------
# the whole model's gradient, as tests/test_gnn_grad.py
# ---------------------------------------------------------------------------

N, F, HID, CLASSES = 18, 6, 8, 3


def _graph(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "random":
        return rng.integers(0, N, (40, 2)).astype(np.int64)
    if kind == "zero_in_degree":
        src = rng.integers(0, N, 30)
        dst = rng.integers(0, N // 2, 30)
        return np.stack([src, dst], axis=1).astype(np.int64)
    return np.stack([np.arange(N)] * 2, axis=1).astype(np.int64)


@pytest.mark.parametrize("kind", ["random", "zero_in_degree",
                                  "self_loops_only"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_grad_matches_reference(arch, kind):
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((N, F)).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int32)
    mask = rng.random(N) < 0.7
    graph = (_graph(kind), N, feats)
    jspec = JaxSpec(arch, F, HID, CLASSES)
    jexe = jax_runtime.compile(jspec, graph, backend="reference",
                               max_shard_n=16)
    jgrads = jax.grad(lambda p: jax_ce(jexe.forward(p), jnp.asarray(labels),
                                       jnp.asarray(mask)))(jexe.params)
    exe = runtime.compile(ZooSpec(arch, F, HID, CLASSES), graph,
                          device="cpu", params=_np_tree(jexe.params),
                          max_shard_n=16)
    tr = runtime.TrainableExecutable(exe, labels, train_mask=mask)
    loss, _, grads = tr.loss_and_grads(tr.params, tr.data(0))
    np.testing.assert_allclose(
        float(loss), float(jax_ce(jexe.forward(), jnp.asarray(labels),
                                  jnp.asarray(mask))), **MODEL_TOL)
    ours, theirs = topt.tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(ours) == len(theirs)
    for g, jg in zip(ours, theirs):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **MODEL_TOL)


# ---------------------------------------------------------------------------
# AdamW and its schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["constant", "cosine", "wsd"])
def test_schedules_match_reference(schedule):
    kw = dict(lr=1e-2, schedule=schedule, warmup_steps=5, total_steps=40)
    ours = topt.make_schedule(topt.AdamWConfig(**kw))
    theirs = jopt.make_schedule(jopt.AdamWConfig(**kw))
    for step in (0, 1, 3, 5, 6, 20, 35, 36, 39, 40, 55):
        np.testing.assert_allclose(
            float(ours(torch.tensor(step, dtype=torch.int32))),
            float(theirs(jnp.int32(step))), rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError):
        topt.make_schedule(topt.AdamWConfig(schedule="step"))(
            torch.tensor(1))


@pytest.mark.parametrize("clip,wd", [(0.0, 0.0), (0.5, 0.1)])
def test_adamw_update_matches_reference(clip, wd):
    """Four steps on a gin-shaped tree (a 0-d ε, matrices and biases):
    decay reaches the matrices only, clipping scales by the global norm."""
    r = np.random.default_rng(7)
    params = {"layers": [{"eps": np.float32(0.3),
                          "w1": r.standard_normal((5, 4)).astype(np.float32),
                          "b1": r.standard_normal(4).astype(np.float32)}]}
    cfg = dict(lr=1e-2, grad_clip=clip, weight_decay=wd, schedule="cosine",
               warmup_steps=2, total_steps=10)
    tp = params_from_numpy(params, "cpu")
    ts = topt.adamw_init(tp)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.adamw_init(jp)
    for _ in range(4):
        g = jax.tree_util.tree_map(
            lambda a: (r.standard_normal(np.shape(a)) * 3).astype(
                np.float32), params)
        tp, ts, tstats = topt.adamw_update(params_from_numpy(g, "cpu"), ts,
                                           tp, topt.AdamWConfig(**cfg))
        jp, js, jstats = jopt.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), js, jp,
            jopt.AdamWConfig(**cfg))
    assert int(ts["step"]) == int(js["step"]) == 4
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tstats[key]), float(jstats[key]),
                                   rtol=1e-6)
    for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)
    for part in ("m", "v"):
        for a, b in zip(topt.tree_leaves(ts[part]),
                        jax.tree.leaves(js[part])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


def test_adamw_leaves_its_arguments_alone():
    p = {"w": torch.ones(3, 2)}
    g = {"w": torch.full((3, 2), 0.5)}
    state = topt.adamw_init(p)
    new_p, new_state, _ = topt.adamw_update(g, state, p, topt.AdamWConfig())
    assert torch.equal(p["w"], torch.ones(3, 2))
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1
    assert not torch.equal(new_p["w"], p["w"])


# ---------------------------------------------------------------------------
# the neighbor sampler, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 11])
def test_sampler_bitwise_matches_reference(seed):
    ds = make_dataset("citeseer", seed=0, scale=0.2)
    kw = dict(batch_nodes=24, fanout=(5, 3), seed=seed,
              seed_ids=np.flatnonzero(ds.train_mask))
    ours = NeighborSampler(ds.edges, ds.profile.num_nodes, **kw)
    theirs = JaxSampler(ds.edges, ds.profile.num_nodes, **kw)
    assert (ours.budget, ours.edge_cap) == (theirs.budget, theirs.edge_cap)
    for step in (0, 1, 7, 100):
        a, b = ours.sample(step), theirs.sample(step)
        for field in ("nodes", "node_valid", "seed_mask", "edges"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field
        assert a.num_real == b.num_real


def test_sampler_edge_cases_match_reference():
    """A small seed pool (seeds drawn with replacement, then deduped), a
    zero-in-degree tail node and an edge-free graph."""
    cases = [(np.array([[0, 1]], np.int64), 3,
              dict(batch_nodes=3, fanout=(2,))),
             (np.empty((0, 2), np.int64), 4, dict(batch_nodes=2, fanout=(2,))),
             (make_dataset("cora", seed=0, scale=0.1).edges, 270,
              dict(batch_nodes=16, fanout=(3,),
                   seed_ids=np.arange(4, dtype=np.int64)))]
    for edges, n, kw in cases:
        a = NeighborSampler(edges, n, **kw).sample(2)
        b = JaxSampler(edges, n, **kw).sample(2)
        assert np.array_equal(a.nodes, b.nodes)
        assert np.array_equal(a.edges, b.edges)
        assert np.array_equal(a.seed_mask, b.seed_mask)


# ---------------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_keep_and_async(tmp_path):
    tree = ({"layers": [{"eps": torch.tensor(0.5),
                         "w": torch.randn(3, 2)}]},
            {"m": {"layers": [{"eps": torch.tensor(0.1),
                               "w": torch.randn(3, 2)}]},
             "step": torch.tensor(7, dtype=torch.int32)})
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2, async_save=True)
    for step in (1, 2, 3):
        mgr.save(tree, step)
    mgr.wait()
    assert sorted(mgr._steps()) == [2, 3]
    template = topt.tree_map(torch.zeros_like, tree)
    restored, step = mgr.restore_latest(template)
    assert step == 3 and isinstance(restored, tuple)
    assert _bitwise_equal(restored, tree)
    assert restored[1]["step"].dtype == torch.int32
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        template) is None


@pytest.fixture(scope="module")
def small_cora():
    return make_dataset("cora", seed=0, scale=0.2)


@pytest.mark.parametrize("batch_nodes", [0, 16])
def test_resume_is_bitwise_deterministic(tmp_path, small_cora, batch_nodes):
    """Train k steps, checkpoint, resume in a fresh fit: params and
    optimizer state bitwise equal to an uninterrupted run (mini-batch:
    the sampler replays the same batches by step)."""
    spec = ZooSpec("gcn", small_cora.profile.feature_dim, 8,
                   small_cora.profile.num_classes)
    kw = dict(device="cpu", batch_nodes=batch_nodes, fanout=(4,), **QUIET)
    whole = runtime.fit(spec, small_cora, steps=6, **kw)
    d = str(tmp_path / "ckpt")
    runtime.fit(spec, small_cora, steps=3,
                ckpt_manager=CheckpointManager(d), ckpt_every=3, **kw)
    resumed = runtime.fit(spec, small_cora, steps=6,
                          ckpt_manager=CheckpointManager(d), ckpt_every=100,
                          **kw)
    assert _bitwise_equal(whole.params, resumed.params)
    assert _bitwise_equal(whole.opt_state, resumed.opt_state)
    assert int(resumed.opt_state["step"]) == 6
    assert _bitwise_equal(resumed.executable.params, resumed.params)


def test_save_load_state_round_trip(tmp_path, small_cora):
    spec = ZooSpec("gin", small_cora.profile.feature_dim, 8,
                   small_cora.profile.num_classes)
    res = runtime.fit(spec, small_cora, steps=3, device="cpu", **QUIET)
    path = tmp_path / "state.npz"
    res.trainable.save_state(path)
    fresh = runtime.fit(spec, small_cora, steps=0, device="cpu", **QUIET)
    state = fresh.trainable.load_state(path)
    assert _bitwise_equal(state["params"], res.params)
    assert _bitwise_equal(fresh.trainable.opt_state, res.opt_state)
    assert _bitwise_equal(fresh.executable.params, res.params)


# ---------------------------------------------------------------------------
# fit against the reference's fit
# ---------------------------------------------------------------------------

def _fit_both(arch, ds, *, steps, **kw):
    prof = ds.profile
    jspec = JaxSpec(arch, prof.feature_dim, 16, prof.num_classes)
    params = _np_tree(init_zoo(jax.random.key(5), jspec))
    common = dict(steps=steps, lr=1e-2, params=params, log_every=1,
                  max_shard_n=64, **QUIET, **kw)
    theirs = jax_runtime.fit(jspec, ds, backend="reference", **common)
    ours = runtime.fit(ZooSpec(arch, prof.feature_dim, 16, prof.num_classes),
                       ds, device="cpu", **common)
    return ours, theirs


@pytest.fixture(scope="module")
def tiny_cora():
    return make_dataset("cora", seed=0, scale=0.1)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_batch_trajectory_matches_reference_fit(tiny_cora, arch):
    """Eight steps of both fits from the same parameters: at each step
    the port's gradient at the reference's parameters equals the
    reference's (atol 1e-6, rtol 1e-4), and the free-running losses
    agree within 1e-3 relative. The losses part faster than the
    gradients: Adam moves a parameter by about lr whatever its
    gradient's size, so an entry whose gradient is rounding noise (in
    sage_max's layers/0/w_pool, 1e-10 beside terms of 5e-4, its sign
    differing between the two sums) moves by ±lr = 1e-2 in the two runs;
    sage_max's losses part by 6.7e-4 relative at step 7 so."""
    ours, theirs = _fit_both(arch, tiny_cora, steps=8)
    assert [s for s, _ in ours.history] == list(range(8))
    np.testing.assert_allclose([l for _, l in ours.history],
                               [l for _, l in theirs.history], rtol=1e-3)

    tr, jtr = ours.trainable, theirs.trainable
    jp = jax.tree_util.tree_map(jnp.asarray, _np_tree(init_zoo(
        jax.random.key(5), jtr.spec)))
    js = jopt.adamw_init(jp)
    fwd, (h, labels, mask) = jtr.executable._forward_fn(), jtr.data(0)
    jgrad = jax.jit(jax.grad(lambda p: jax_ce(fwd(p, h), labels, mask)))
    for _ in range(8):
        jgrads = jgrad(jp)
        at = topt.tree_unflatten(tr.params, [_t(np.array(x))
                                             for x in jax.tree.leaves(jp)])
        _, _, grads = tr.loss_and_grads(at, tr.data(0))
        for g, jg in zip(topt.tree_leaves(grads), jax.tree.leaves(jgrads)):
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-6,
                                       rtol=1e-4)
        jp, js, _ = jtr._jit_step(jp, js, h, labels, mask)


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_mini_batch_trajectory_matches_reference_fit(tiny_cora, arch):
    """The same sampled subgraphs, planned to the same template; losses
    within 1e-3 relative (as the full-batch test says why)."""
    ours, theirs = _fit_both(arch, tiny_cora, steps=6, batch_nodes=16,
                             fanout=(4, 3))
    tr, jtr = ours.trainable, theirs.trainable
    assert tr.minibatch_plan.to_json() == jtr.minibatch_plan.to_json()
    assert tr._mb_shape == jtr._mb_shape
    np.testing.assert_allclose([l for _, l in ours.history],
                               [l for _, l in theirs.history], rtol=1e-3)


@pytest.mark.parametrize("arch", ["gcn", "sage_mean", "gin"])
def test_trains_cora_to_accuracy(arch):
    """≥ 0.75 train accuracy within 150 full-batch steps, as the
    reference's gate (tests/test_gnn_train.py), on cora at scale 0.3 on
    the CPU (the full-scale run is a ``cuda`` test)."""
    ds = make_dataset("cora", seed=0, scale=0.3)
    spec = ZooSpec(arch, ds.profile.feature_dim, 16, ds.profile.num_classes)
    res = runtime.fit(spec, ds, steps=150, lr=1e-2, device="cpu", **QUIET)
    acc = res.train_accuracy()
    assert acc >= 0.75, f"{arch}: train acc {acc:.3f} < 0.75"
    assert res.history[-1][1] < 0.7 * res.history[0][1]
    assert _bitwise_equal(res.executable.params, res.params)


def test_fit_requires_labels_and_features(tiny_cora):
    spec = ZooSpec("gcn", tiny_cora.profile.feature_dim, 8,
                   tiny_cora.profile.num_classes)
    g = tiny_cora
    with pytest.raises(ValueError, match="labels"):
        runtime.fit(spec, (g.edges, g.profile.num_nodes, g.features),
                    steps=1, device="cpu", **QUIET)
    with pytest.raises(ValueError, match="features"):
        runtime.fit(spec, (g.edges, g.profile.num_nodes), labels=g.labels,
                    steps=1, device="cpu", **QUIET)


def test_unported_training_paths_raise(tiny_cora):
    spec = ZooSpec("gcn", tiny_cora.profile.feature_dim, 8,
                   tiny_cora.profile.num_classes)
    res = runtime.fit(spec, tiny_cora, steps=1, batch_nodes=8, fanout=(2,),
                      device="cpu", **QUIET)
    # the collective accounting is ported; like the reference's, it needs
    # a mesh-compiled trainable (tests/test_torch_dist_train.py)
    for call in (res.trainable.train_comm_stats,
                 res.trainable.verify_train_comm):
        with pytest.raises(ValueError, match="mesh"):
            call()
    # update_sampler is ported (the streaming fine-tune): it refuses a
    # sampler of another template instead
    with pytest.raises(ValueError, match="template mismatch"):
        res.trainable.update_sampler(NeighborSampler(
            tiny_cora.edges, tiny_cora.profile.num_nodes, batch_nodes=8,
            fanout=(3,)))


# ---------------------------------------------------------------------------
# serving first, training after, on one graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gcn", "gat", "sage_max"])
def test_serve_then_train_on_the_same_graph(tiny_cora, arch):
    """The first forward that builds the graph's kept index is a serving
    forward (inference mode); a training step on the same GraphTensors
    then saves index tensors for its backward, which needs them built
    outside inference mode."""
    prof = tiny_cora.profile
    exe = runtime.compile(ZooSpec(arch, prof.feature_dim, 8,
                                  prof.num_classes),
                          tiny_cora, device="cpu", max_shard_n=64)
    before = exe.forward()
    exe.predict([0, 1, 2])
    assert not exe.gt.linear_index.val.is_inference()
    tr = runtime.TrainableExecutable(exe, tiny_cora.labels,
                                     train_mask=tiny_cora.train_mask)
    tr.run(2, **QUIET)
    assert not exe.has_cached_probs
    assert not torch.equal(exe.forward(), before)


def test_masked_cross_entropy_matches_reference():
    r = np.random.default_rng(8)
    logits = r.standard_normal((10, 4)).astype(np.float32) * 3
    labels = r.integers(0, 4, 10).astype(np.int32)
    for mask in (r.random(10) < 0.5, np.zeros(10, bool)):
        np.testing.assert_allclose(
            float(masked_cross_entropy(_t(logits), _t(labels), _t(mask))),
            float(jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                         jnp.asarray(mask))), rtol=1e-6)
