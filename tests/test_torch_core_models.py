"""The paper's Table-III networks (``repro_torch.core.models``) against
``repro.core.models``.

The same numpy graph, features and parameters (drawn by the reference's
``init_gnn``, handed over through ``gnn.models.params_from_numpy``) go
through both packages' ``build_graph_tensors`` and ``make_forward``. The
reference runs on its ``reference`` backend (the plain jnp oracles); the
port on its default ``cuda`` backend, which runs the plain versions for
CPU tensors. float32 throughout: atol = rtol = 1e-4.

The ``cuda``-marked twins hold the kernels to the plain versions on a
card (logits, gradients, launches); they skip here. The reference
package is imported inside fixtures only, so they import on a machine
without JAX.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core import models
from repro_torch.core.engines import (DenseEngine, GNNeratorController,
                                      GraphEngine)
from repro_torch.gnn.models import params_from_numpy
from repro_torch.kernels import _lib, csr, ops, ref
from repro_torch.kernels.registry import get_backend
from repro_torch.runtime.fit import masked_cross_entropy
from torch_launches import PAPER_FORWARD_LAUNCHES

KINDS = ("gcn", "graphsage", "graphsage_pool")
TOL = dict(atol=1e-4, rtol=1e-4)
# ||g_cuda - g_reference|| / ||g_reference|| per parameter on the card: the
# backward is the same plain autograd on both sides; the forwards differ
# by the kernels' rounding (~1e-7 relative), as chip_smoke.py's GRAD_REL
GRAD_REL = 1e-4


@pytest.fixture(scope="module")
def jx():
    """The reference package's models on its ``reference`` backend."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import engines as jengines
    from repro.core import models as jmodels
    from repro.kernels import registry as jregistry

    be = jregistry.get_backend("reference")
    ctrl = jengines.GNNeratorController(
        dense=jengines.DenseEngine(backend=be),
        graph=jengines.GraphEngine(backend=be))
    return types.SimpleNamespace(jax=jax, jnp=jnp, models=jmodels,
                                 ctrl=ctrl, registry=jregistry)


def _toy_graph(n_nodes=50, n_edges=200, seed=0):
    r = np.random.default_rng(seed)
    e = r.integers(0, n_nodes, (n_edges, 2))
    return e[e[:, 0] != e[:, 1]]


def _features(n_nodes, dim, seed):
    return np.random.default_rng(seed).standard_normal(
        (n_nodes, dim)).astype(np.float32)


def _jax_params(jx, spec, seed):
    """The reference's ``init_gnn`` parameters as numpy."""
    p = jx.models.init_gnn(jx.jax.random.key(seed), spec)
    return jx.jax.tree_util.tree_map(np.asarray, p)


def _reference_ctrl():
    be = get_backend("reference")
    return GNNeratorController(dense=DenseEngine(backend=be),
                               graph=GraphEngine(backend=be))


def _leaves(params):
    return [(f"layers/{i}/{k}", v) for i, layer in enumerate(params["layers"])
            for k, v in layer.items()]


# ---------------------------------------------------------------------------
# the forward against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("kind", KINDS)
def test_make_forward_matches_reference(jx, kind, n):
    edges = _toy_graph(80, 300, seed=1)
    feats = _features(80, 24, seed=0)
    jspec = jx.models.paper_spec(kind, 24, 5)
    jp = _jax_params(jx, jspec, seed=3)
    jgt = jx.models.build_graph_tensors(edges, 80, n=n, kind=kind)
    expect = np.asarray(jx.models.make_forward(jspec, jx.ctrl)(
        jp, jgt, jgt.group(jx.jnp.asarray(feats))))

    spec = models.paper_spec(kind, 24, 5)
    assert spec.layer_dims == jspec.layer_dims
    gt = models.build_graph_tensors(edges, 80, n, kind, device="cpu")
    for name in ("blocks", "edge_src", "edge_dst", "edge_valid"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(jgt, name)))
    params = params_from_numpy(jp, "cpu")
    h = gt.group(torch.from_numpy(feats))
    for ctrl in (None, _reference_ctrl()):
        out = models.make_forward(spec, ctrl)(params, gt, h)
        assert out.shape == (80, 5) and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), expect, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_init_gnn_tree_matches_reference(jx, kind):
    """Same keys and shapes as the reference's ``init_gnn``; drawn on the
    generator's device with glorot-normal scale."""
    spec = models.paper_spec(kind, 64, 7)
    jp = _jax_params(jx, jx.models.paper_spec(kind, 64, 7), seed=0)
    got = models.init_gnn(torch.Generator().manual_seed(0), spec)
    # (JAX's tree_map lists a dict's keys sorted)
    assert sorted((k, tuple(v.shape)) for k, v in _leaves(got)) == \
        sorted((k, v.shape) for k, v in _leaves(jp))
    for key, w in _leaves(got):
        assert w.dtype == torch.float32 and w.device.type == "cpu"
        fan_in, fan_out = w.shape[0], w.shape[-1]
        if w.numel() >= 1000:
            want = (2.0 / (fan_in + fan_out)) ** 0.5
            assert abs(w.std().item() / want - 1) < 0.1, key
    again = models.init_gnn(torch.Generator().manual_seed(0), spec)
    assert all(torch.equal(a, b) for (_, a), (_, b)
               in zip(_leaves(got), _leaves(again)))


def test_paper_networks_match_reference(jx):
    assert models.PAPER_NETWORKS == jx.models.PAPER_NETWORKS
    for net in KINDS:
        spec = models.paper_spec(net, 500, 3)
        jspec = jx.models.paper_spec(net, 500, 3)
        assert spec.__dict__ == jspec.__dict__
    with pytest.raises(ValueError):
        models.init_gnn(torch.Generator(),
                        models.GNNSpec("gin", 4, 4, 2))


# ---------------------------------------------------------------------------
# tests/test_core.py's forward tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_forward_shapes_and_finite(kind):
    edges = _toy_graph(80, 300, seed=1)
    feats = _features(80, 24, seed=0)
    gt = models.build_graph_tensors(edges, 80, 32, kind, device="cpu")
    spec = models.paper_spec(kind, 24, 5)
    params = models.init_gnn(torch.Generator().manual_seed(0), spec)
    out = models.make_forward(spec)(params, gt,
                                    gt.group(torch.from_numpy(feats)))
    assert out.shape == (80, 5)
    assert bool(torch.isfinite(out).all())


def test_gcn_matches_dense_reference():
    """The whole sharded pipeline equals the textbook dense GCN."""
    edges = _toy_graph(40, 160, seed=7)
    n_nodes, f_in, f_out = 40, 16, 4
    feats = _features(n_nodes, f_in, seed=1)
    gt = models.build_graph_tensors(edges, n_nodes, 16, "gcn", device="cpu")
    spec = models.paper_spec("gcn", f_in, f_out)
    params = models.init_gnn(torch.Generator().manual_seed(1), spec)
    out = models.make_forward(spec)(params, gt,
                                    gt.group(torch.from_numpy(feats)))

    # dense reference: Â = D^-1/2 (A+I) D^-1/2 (per-direction degrees)
    a = np.zeros((n_nodes, n_nodes), np.float64)
    for s, d in edges:
        a[d, s] += 1.0
    a += np.eye(n_nodes)
    ahat = a / np.sqrt(np.maximum(np.outer(a.sum(1), a.sum(0)), 1.0))
    h = feats.astype(np.float64)
    ws = [layer["w"].double().numpy() for layer in params["layers"]]
    for i, w in enumerate(ws):
        h = ahat @ h @ w
        if i < len(ws) - 1:
            h = np.maximum(h, 0)
    np.testing.assert_allclose(out.numpy(), h, **TOL)


def test_shard_size_invariance():
    """Changing the shard size n (hence S) does not change the logits."""
    edges = _toy_graph(60, 240, seed=9)
    feats = torch.from_numpy(_features(60, 12, seed=2))
    spec = models.paper_spec("gcn", 12, 3)
    params = models.init_gnn(torch.Generator().manual_seed(2), spec)
    fwd = models.make_forward(spec)
    outs = []
    for n in (16, 32, 64):
        gt = models.build_graph_tensors(edges, 60, n, "gcn", device="cpu")
        outs.append(fwd(params, gt, gt.group(feats)).numpy())
    np.testing.assert_allclose(outs[0], outs[1], **TOL)
    np.testing.assert_allclose(outs[0], outs[2], **TOL)


# ---------------------------------------------------------------------------
# tests/test_kernels_grad.py: each op's gradient, and a training step,
# against jax.grad of the reference
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(7)


def _op_grads(t_fn, j_fn, jx, *inputs):
    """Gradients of sum(out²) w.r.t. every input: the port's op through
    ``kernels.ops`` (default backend) and ``jax.grad`` of the reference."""
    xs = [torch.from_numpy(x).requires_grad_() for x in inputs]
    got = torch.autograd.grad(t_fn(*xs).square().sum(), xs)
    expect = jx.jax.grad(
        lambda *a: jx.jnp.sum(jx.jnp.square(j_fn(*a))),
        argnums=tuple(range(len(inputs))))(*map(jx.jnp.asarray, inputs))
    for g, e in zip(got, expect):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), **TOL)


def test_dense_matmul_grad(jx):
    jref = jx.registry.get_backend("reference")
    x = RNG.standard_normal((24, 16)).astype(np.float32)
    w = RNG.standard_normal((16, 8)).astype(np.float32)
    b = RNG.standard_normal((8,)).astype(np.float32)
    _op_grads(lambda x, w, b: ops.dense_matmul(x, w, b, activation="relu"),
              lambda x, w, b: jref.dense_matmul(x, w, b, activation="relu"),
              jx, x, w, b)


def test_shard_spmm_grad(jx):
    jref = jx.registry.get_backend("reference")
    a = (RNG.random((2, 2, 8, 8)) < 0.3).astype(np.float32)
    h = RNG.standard_normal((2, 8, 16)).astype(np.float32)
    index = csr.linear_index(torch.from_numpy(a))
    _op_grads(lambda h: ops.graph_aggregate(torch.from_numpy(a), h,
                                            index=index),
              lambda h: jref.graph_aggregate(jx.jnp.asarray(a), h), jx, h)


def test_fused_gnn_grad(jx):
    jref = jx.registry.get_backend("reference")
    a = (RNG.random((2, 2, 8, 8)) < 0.3).astype(np.float32)
    h = RNG.standard_normal((2, 8, 16)).astype(np.float32)
    w = RNG.standard_normal((16, 4)).astype(np.float32)
    _op_grads(lambda h, w: ops.fused_aggregate_extract(
                  torch.from_numpy(a), h, w, activation="relu"),
              lambda h, w: jref.fused_aggregate_extract(
                  jx.jnp.asarray(a), h, w, activation="relu"), jx, h, w)


@pytest.mark.parametrize("op", ["max", "sum"])
def test_gather_aggregate_grad(jx, op):
    jref = jx.registry.get_backend("reference")
    s, n, e, d = 2, 8, 12, 16
    es = RNG.integers(0, n, (s, s, e)).astype(np.int32)
    ed = RNG.integers(0, n, (s, s, e)).astype(np.int32)
    ev = RNG.random((s, s, e)) < 0.6
    h = RNG.standard_normal((s, n, d)).astype(np.float32)
    t_edges = [torch.from_numpy(x) for x in (es, ed, ev)]
    j_edges = [jx.jnp.asarray(x) for x in (es, ed, ev)]
    _op_grads(lambda h: ops.gather_aggregate(*t_edges, h, op=op),
              lambda h: jref.gather_aggregate(*j_edges, h, op=op), jx, h)


def _jax_loss_and_grads(jx, spec, jp, edges, n_nodes, n, feats, labels,
                        mask):
    jgt = jx.models.build_graph_tensors(edges, n_nodes, n=n, kind=spec.kind)
    fwd = jx.models.make_forward(spec, jx.ctrl)
    hg = jgt.group(jx.jnp.asarray(feats))
    jlabels, jmask = jx.jnp.asarray(labels), jx.jnp.asarray(mask)

    def loss(p):
        logp = jx.jax.nn.log_softmax(fwd(p, jgt, hg))
        nll = -jx.jnp.take_along_axis(logp, jlabels[:, None], 1)[:, 0]
        return jx.jnp.sum(nll * jmask) / jx.jnp.sum(jmask)

    value, grads = jx.jax.value_and_grad(loss)(
        jx.jax.tree_util.tree_map(jx.jnp.asarray, jp))
    return float(value), jx.jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("kind", KINDS)
def test_gnn_end_to_end_training_step(jx, kind):
    """A masked cross-entropy step: loss and every gradient equal
    ``jax.grad`` of the reference; one SGD step moves every parameter."""
    edges = RNG.integers(0, 40, (150, 2))
    feats = RNG.standard_normal((40, 12)).astype(np.float32)
    labels = RNG.integers(0, 4, 40).astype(np.int32)
    mask = RNG.random(40) < 0.6
    jspec = jx.models.paper_spec(kind, 12, 4)
    jp = _jax_params(jx, jspec, seed=0)
    jloss, jgrads = _jax_loss_and_grads(jx, jspec, jp, edges, 40, 16, feats,
                                        labels, mask)

    spec = models.paper_spec(kind, 12, 4)
    gt = models.build_graph_tensors(edges, 40, 16, kind, device="cpu")
    params = params_from_numpy(jp, "cpu")
    leaves = [v.requires_grad_() for _, v in _leaves(params)]
    logits = models.make_forward(spec)(params, gt,
                                       gt.group(torch.from_numpy(feats)))
    loss = masked_cross_entropy(logits, torch.from_numpy(labels).long(),
                                torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, leaves)
    assert np.isclose(loss.item(), jloss, **TOL)
    jgrads = dict(_leaves(jgrads))
    for (key, _), g in zip(_leaves(params), grads):
        assert bool(torch.isfinite(g).all()) and g.abs().sum() > 0, key
        np.testing.assert_allclose(g.numpy(), jgrads[key], err_msg=key,
                                   **TOL)
    with torch.no_grad():
        moved = [(w - 0.1 * g) for w, g in zip(leaves, grads)]
    assert all(not torch.equal(m, w) for m, w in zip(moved, leaves))


# ---------------------------------------------------------------------------
# the plain edge walks in column blocks (what keeps reddit's backward on a
# card): the same function as one block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("walk", ["spmm_indexed", "seg_gather_max",
                                  "seg_gather_sum", "seg_gather_indexed"])
def test_plain_walks_in_column_blocks_match_one_block(walk, monkeypatch):
    g = torch.Generator().manual_seed(0)
    s, n, d = 3, 16, 5
    a = (torch.rand((s, s, n, n), generator=g) < 0.3) * \
        torch.rand((s, s, n, n), generator=g)
    es = torch.randint(0, n, (s, s, 40), generator=g, dtype=torch.int32)
    ed = torch.randint(0, n, (s, s, 40), generator=g, dtype=torch.int32)
    ev = torch.rand((s, s, 40), generator=g) < 0.6
    h = torch.randn((s, n, d), generator=g)
    index = csr.linear_index(a)
    val = index.val.clone()
    fn = {"spmm_indexed": lambda x, v: ref.spmm_indexed(
              dataclasses.replace(index, val=v), x),
          "seg_gather_max": lambda x, v: ref.seg_gather(es, ed, ev, x.relu(),
                                                        op="max"),
          "seg_gather_sum": lambda x, v: ref.seg_gather(es, ed, ev, x,
                                                        op="sum"),
          "seg_gather_indexed": lambda x, v: ref.seg_gather_indexed(
              csr.gather_index(es, ed, ev, n), x.relu(), op="max")}[walk]

    def run():
        x, v = h.clone().requires_grad_(), val.clone().requires_grad_()
        out = fn(x, v)
        grads = torch.autograd.grad(out.square().sum(), (x, v),
                                    allow_unused=True)
        return out.detach(), grads

    whole, g_whole = run()
    # 2 columns a block: 3 blocks of the 5
    monkeypatch.setattr(ref, "PLAIN_BLOCK_ELEMENTS", 2 * ev.numel())
    blocked, g_blocked = run()
    # every column reduces alone, in the same edge order: the forward is
    # bitwise the same; gradients summed over columns (the weights') add
    # the blocks' parts in another order
    assert torch.equal(blocked, whole)
    for gb, gw in zip(g_blocked, g_whole):
        if gw is not None:
            torch.testing.assert_close(gb, gw, **TOL)
    with torch.no_grad():
        assert torch.equal(fn(h, val), whole)


# ---------------------------------------------------------------------------
# on the card: the kernels against the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "-m cuda tests/test_torch_core_models.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _requiring_grad(params):
    """A copy of ``params`` whose leaves need gradients, and the leaves."""
    tree = {"layers": [{k: v.detach().clone().requires_grad_()
                        for k, v in layer.items()}
                       for layer in params["layers"]]}
    return tree, [v for _, v in _leaves(tree)]


def _launched(fn):
    torch.cuda.synchronize()
    _lib.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _lib.launches().items() if v}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_paper_network_matches_reference_backend(cuda, kind):
    """Cora at full scale: logits within 1e-4 of the ``reference``
    backend, launches per forward exactly ``PAPER_FORWARD_LAUNCHES``, a
    train step launches the same, gradients within ``GRAD_REL``."""
    from repro_torch.graphs.datasets import make_dataset

    ds = make_dataset("cora", seed=0)
    spec = models.paper_spec(kind, ds.profile.feature_dim,
                             ds.profile.num_classes)
    params = models.init_gnn(torch.Generator(cuda).manual_seed(0), spec)
    gt = models.build_graph_tensors(ds.edges, ds.profile.num_nodes, 512,
                                    kind, device=cuda)
    h = gt.group(torch.from_numpy(ds.features).to(cuda))
    labels = torch.from_numpy(ds.labels).long().to(cuda)
    mask = torch.from_numpy(ds.train_mask).to(cuda)
    grads, logits = {}, {}
    for name, ctrl in (("cuda", None), ("reference", _reference_ctrl())):
        fwd = models.make_forward(spec, ctrl)
        p, leaves = _requiring_grad(params)

        def step():
            out = fwd(p, gt, h)
            return out, torch.autograd.grad(
                masked_cross_entropy(out, labels, mask), leaves)

        (out, g), launched = _launched(step)
        if name == "cuda":
            assert launched == PAPER_FORWARD_LAUNCHES[kind]
            with torch.no_grad():
                _, fwd_only = _launched(lambda: fwd(params, gt, h))
            assert fwd_only == PAPER_FORWARD_LAUNCHES[kind]
        else:
            assert launched == {}
        logits[name], grads[name] = out.detach(), g
    torch.testing.assert_close(logits["cuda"], logits["reference"], **TOL)
    for g, e in zip(grads["cuda"], grads["reference"]):
        assert bool(torch.isfinite(g).all()) and g.abs().sum() > 0
        assert ((g - e).norm() / e.norm()).item() <= GRAD_REL
