"""shard_spmm over the blocks' destination-sorted nonzeros.

The indexed plain walk ``ref.spmm_indexed(csr.linear_index(A), h)`` is
held to the reference package's Pallas ``shard_spmm`` in interpret mode
(or its backend, which pads a ragged D) on the same numpy inputs, at
atol = rtol = 1e-4 (float32 products): square and rectangular grids, a
ragged D, a destination shard with no edge and a hub row. The wrapper,
the registry, ``GraphEngine.aggregate`` and a whole sage_mean forward are
held to passing the graph's kept index through. The kernel itself is
held to these plain versions on the card (tests/test_torch_kernels.py,
``cuda``).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core.engines import GraphEngine, GraphTensors
from repro_torch.core.sharding import shard_graph
from repro_torch.kernels import csr, ops, ref, registry
from repro_torch.kernels import shard_spmm as t_spmm

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blocks(r, s_dst, s_src, n, density, *, empty=False, hub=False):
    """Random weighted (S_dst, S_src, n, n) blocks; with ``empty``
    destination shard 0 has no nonzero, with ``hub`` row 1 of the last
    destination shard has a nonzero at every source row."""
    a = np.where(r.random((s_dst, s_src, n, n)) < density,
                 r.standard_normal((s_dst, s_src, n, n)), 0.0)
    a = a.astype(np.float32)
    if empty:
        a[0] = 0.0
    if hub:
        a[-1, :, 1, :] = 0.5
    return a


@pytest.fixture
def jspmm():
    pytest.importorskip("jax")
    from repro.kernels import registry as jreg
    from repro.kernels.shard_spmm import shard_spmm
    return types.SimpleNamespace(kernel=shard_spmm,
                                 pallas=jreg.get_backend("pallas"))


@pytest.mark.parametrize("s_dst,s_src,n,d,bb,empty,hub", [
    (2, 2, 16, 32, 16, False, False),    # square
    (4, 4, 8, 64, 32, False, False),     # square, more shards
    (2, 3, 8, 32, 16, False, False),     # rectangular, S_dst < S_src
    (3, 2, 16, 48, 16, True, False),     # rectangular, S_dst > S_src
    (3, 3, 16, 40, 16, False, False),    # ragged D: the backend pads it
    (2, 3, 12, 21, 16, True, True),      # ragged D on a rectangular grid
    (3, 3, 16, 32, 16, True, False),     # a destination shard with no edge
    (2, 2, 40, 32, 16, False, True),     # a hub row of 80 entries
])
def test_indexed_spmm_walk_matches_pallas(jspmm, s_dst, s_src, n, d, bb,
                                          empty, hub):
    r = np.random.default_rng(s_dst * 1000 + s_src * 100 + n + d)
    a = _blocks(r, s_dst, s_src, n, 0.2, empty=empty, hub=hub)
    h = r.standard_normal((s_src, n, d), np.float32)
    if d % bb == 0:
        exp = jspmm.kernel(a, h, block_b=bb, interpret=True)
    else:
        exp = jspmm.pallas.graph_aggregate(a, h, block_b=bb)
    exp = np.asarray(exp)
    index = csr.linear_index(_t(a))
    assert index.row_ptr.numel() == s_dst * n + 1
    assert int(index.col.max()) < s_src * n
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).numpy()
    if empty:
        assert (counts[:n] == 0).all() and (exp[0] == 0).all()
    if hub:
        row = (s_dst - 1) * n + 1
        assert counts[row] == s_src * n > csr.HUB_ENTRIES
        assert row in index.hubs.tolist()
    out = ref.spmm_indexed(index, _t(h))
    assert out.shape == (s_dst, n, d)
    np.testing.assert_allclose(out.numpy(), exp, **TOL)
    whole = t_spmm.shard_spmm(_t(a), _t(h), index=index)
    np.testing.assert_allclose(whole.numpy(), exp, **TOL)


def test_spmm_wrapper_with_and_without_index_agree():
    r = np.random.default_rng(50)
    a = _t(_blocks(r, 2, 3, 10, 0.3, empty=True, hub=True))
    h = _t(r.standard_normal((3, 10, 6), np.float32))
    index = csr.linear_index(a)
    standalone = t_spmm.shard_spmm(a, h)
    for out in (t_spmm.shard_spmm(a, h, index=index),
                ops.graph_aggregate(a, h, index=index),
                ops.graph_aggregate(a, h, index=index, backend="reference")):
        torch.testing.assert_close(out, standalone, atol=0, rtol=0)
    torch.testing.assert_close(ref.spmm_indexed(index, h), standalone, **TOL)


def test_spmm_index_on_another_device_is_refused():
    r = np.random.default_rng(51)
    a = _t(_blocks(r, 2, 2, 4, 0.3))
    h = _t(r.standard_normal((2, 4, 3), np.float32))
    index = csr.linear_index(a)
    meta = csr.LinearIndex(*(t.to("meta") for t in
                             (index.row_ptr, index.col, index.val,
                              index.hubs)))
    with pytest.raises(ValueError, match="devices"):
        t_spmm.shard_spmm(a, h, index=meta)


def _bad(index, field, value):
    return dataclasses.replace(index, **{field: value})


@pytest.mark.parametrize("case", [
    "rows", "lengths", "col_dtype", "val_dtype", "row_ptr_rank",
    "hubs_dtype", "strided"])
def test_check_linear_index_refuses_what_no_kernel_can_walk(case):
    """The checks both wrappers run before a launch: the index's dtypes,
    ranks, contiguity, its row count (S_dst·n + 1 offsets) and entries
    (as many values as columns)."""
    a = _t(_blocks(np.random.default_rng(52), 2, 3, 6, 0.4))
    index = csr.linear_index(a)
    csr.check_linear_index("shard_spmm", index, 2 * 6)     # a good one
    bad = {
        "rows": _bad(index, "row_ptr", index.row_ptr[:-1].contiguous()),
        "lengths": _bad(index, "val", index.val[:-1].contiguous()),
        "col_dtype": _bad(index, "col", index.col.long()),
        "val_dtype": _bad(index, "val", index.val.double()),
        "row_ptr_rank": _bad(index, "row_ptr", index.row_ptr[None]),
        "hubs_dtype": _bad(index, "hubs", index.hubs.long()),
        "strided": _bad(index, "col", torch.stack(
            [index.col, index.col], 1)[:, 0]),
    }[case]
    with pytest.raises(ValueError, match="shard_spmm"):
        csr.check_linear_index("shard_spmm", bad, 2 * 6)


def test_registry_passes_the_spmm_index_to_the_kernel(monkeypatch):
    """The cuda backend hands ``index`` to the kernel wrapper; the
    reference backend runs the whole plain function and never reads it."""
    seen = {}

    def spy(blocks, h, *, index=None):
        seen["index"] = index
        return ref.shard_spmm(blocks, h)

    monkeypatch.setattr(registry, "shard_spmm", spy)
    r = np.random.default_rng(53)
    a = _t(_blocks(r, 2, 2, 6, 0.3))
    h = _t(r.standard_normal((2, 6, 5), np.float32))
    index = csr.linear_index(a)
    registry.resolve("cuda").graph_aggregate(a, h, index=index)
    assert seen["index"] is index
    registry.resolve("cuda").graph_aggregate(a, h)
    assert seen["index"] is None
    bogus = csr.LinearIndex(row_ptr=torch.zeros(1, dtype=torch.int32),
                            col=torch.zeros(0, dtype=torch.int32),
                            val=torch.zeros(0),
                            hubs=torch.zeros(0, dtype=torch.int32))
    out = registry.resolve("reference").graph_aggregate(a, h, index=bogus)
    torch.testing.assert_close(out, ref.shard_spmm(a, h), atol=0, rtol=0)


class _Walk(registry.CudaBackend):
    """The cuda backend whose linear aggregation is the kernel's walk,
    ``ref.spmm_indexed`` over the index it is handed (built in the call
    when there is none); records each index."""

    def __init__(self):
        self.seen = []

    def graph_aggregate(self, blocks, h, *, index=None):
        self.seen.append(index)
        return ref.spmm_indexed(
            csr.linear_index(blocks) if index is None else index, h)


def _graph(normalize, loops, num_nodes=37, n=16, seed=54):
    r = np.random.default_rng(seed)
    edges = r.integers(0, num_nodes, (120, 2)).astype(np.int64)
    sg = shard_graph(edges, num_nodes, n, normalize=normalize,
                     add_self_loops=loops)
    return sg, GraphTensors.from_sharded(sg, "cpu")


@pytest.mark.parametrize("normalize,loops", [("mean", False), ("gcn", True),
                                             ("sum", False)])
def test_graph_engine_linear_aggregate_passes_the_graphs_index(normalize,
                                                               loops):
    """aggregate(op="linear") walks the graph's kept index (built at the
    first call, then reused); spmm on explicit blocks builds its own."""
    sg, gt = _graph(normalize, loops)
    walk = _Walk()
    engine = GraphEngine(walk)
    h = _t(np.random.default_rng(55).standard_normal((sg.S, sg.n, 7),
                                                     np.float32))
    assert "linear_index" not in gt.__dict__
    first = engine.aggregate(gt, h, op="linear")
    again = engine.aggregate(gt, h, op="linear")
    assert walk.seen[0] is walk.seen[1] is gt.linear_index
    expect = ref.shard_spmm(gt.blocks, h)
    torch.testing.assert_close(first, expect, **TOL)
    torch.testing.assert_close(again, first, atol=0, rtol=0)
    torch.testing.assert_close(engine.spmm(gt.blocks, h), expect, **TOL)
    assert walk.seen[2] is None


@pytest.fixture
def jforward():
    jax = pytest.importorskip("jax")
    from repro.gnn.models import ZooSpec as JaxSpec
    from repro.gnn.models import init_zoo
    from repro.kernels.registry import get_backend
    from repro.runtime.forward import build_graph_tensors as jax_build
    from repro.runtime.forward import forward as jax_forward
    return types.SimpleNamespace(jax=jax, spec=JaxSpec, init=init_zoo,
                                 backend=get_backend, build=jax_build,
                                 forward=jax_forward)


def test_sage_mean_forward_walks_the_kept_index_and_matches_jax(jforward):
    """The slice as a whole: sage_mean (two linear aggregations) through
    the kernel's walk over the graph's kept index against the reference
    package's forward on the same graph, features and parameters."""
    import jax.numpy as jnp

    from repro_torch.gnn.models import ZooSpec, params_from_numpy
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.runtime.forward import build_graph_tensors, forward

    graph = make_dataset("cora", seed=0, scale=0.1)
    prof = graph.profile
    dims = (prof.feature_dim, 16, prof.num_classes)
    jspec = jforward.spec("sage_mean", *dims, num_layers=2)
    jparams = jforward.jax.tree_util.tree_map(
        np.asarray, jforward.init(jforward.jax.random.key(3), jspec))
    jgt = jforward.build(graph.edges, prof.num_nodes, 64, "sage_mean")
    exp = jforward.forward(jspec, jparams, jgt,
                           jgt.group(jnp.asarray(graph.features)),
                           backend=jforward.backend("reference"))
    gt = build_graph_tensors(graph.edges, prof.num_nodes, 64, "sage_mean",
                             "cpu")
    walk = _Walk()
    out = forward(ZooSpec("sage_mean", *dims, num_layers=2),
                  params_from_numpy(jparams, "cpu"), gt,
                  gt.group(torch.from_numpy(graph.features)), backend=walk)
    assert len(walk.seen) == 2
    assert all(i is gt.linear_index for i in walk.seen)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)
