"""The destination-sorted gather index of the port's seg_gather.

``gather_index`` is held to a numpy construction of the same CSR (each
destination row's edges in (j, e) order, out-of-range ids dropped), the
indexed plain walk ``ref.seg_gather_indexed`` to the reference package's
Pallas kernel in interpret mode on the same numpy inputs (max exact, sum
within 1e-6), and ``GraphTensors.from_sharded`` to carrying the index of
its own edge lists. The kernel itself is held to these plain versions on
the card (tests/test_torch_kernels.py, ``cuda``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engines import GraphTensors
from repro_torch.core.sharding import shard_graph
from repro_torch.kernels import ops, ref
from repro_torch.kernels import seg_gather as t_gather


def _edges(r, s_dst, s_src, n, e, p_valid=0.6):
    es = r.integers(0, n, (s_dst, s_src, e)).astype(np.int32)
    ed = r.integers(0, n, (s_dst, s_src, e)).astype(np.int32)
    ev = r.random((s_dst, s_src, e)) < p_valid
    return es, ed, ev


def _numpy_index(es, ed, ev, n):
    """Walk the slots in (i, j, e) order; append each kept edge to its
    destination row."""
    s_dst, s_src, e = es.shape
    rows = [[] for _ in range(s_dst * n)]
    for i in range(s_dst):
        for j in range(s_src):
            for k in range(e):
                u, v = int(es[i, j, k]), int(ed[i, j, k])
                if ev[i, j, k] and 0 <= u < n and 0 <= v < n:
                    rows[i * n + v].append(j * n + u)
    row_ptr = np.concatenate([[0], np.cumsum([len(x) for x in rows])])
    src = np.array([u for x in rows for u in x], dtype=np.int32)
    return row_ptr.astype(np.int32), src


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("s_dst,s_src,n,e", [(2, 2, 8, 16), (3, 2, 16, 40),
                                             (1, 4, 5, 7)])
def test_gather_index_matches_numpy_construction(s_dst, s_src, n, e):
    r = np.random.default_rng(s_dst * 100 + s_src * 10 + n)
    es, ed, ev = _edges(r, s_dst, s_src, n, e)
    es[0, 0, :3] = (-1, n, n + 3)       # out-of-range ids are dropped
    ed[0, 0, 3:5] = (n, -2)
    ev[0, 0, :5] = True
    index = t_gather.gather_index(_t(es), _t(ed), _t(ev), n)
    row_ptr, src = _numpy_index(es, ed, ev, n)
    assert index.row_ptr.dtype == torch.int32
    assert index.src.dtype == torch.int32
    np.testing.assert_array_equal(index.row_ptr.numpy(), row_ptr)
    np.testing.assert_array_equal(index.src.numpy(), src)


def test_gather_index_keeps_each_rows_slot_order():
    """Three edges into one destination from shards 1, 0, 1 (slots 2, 5,
    0): the row lists them as (j, e) order gives them — j = 0 first, then
    j = 1's slots 0 and 2."""
    n = 4
    es = np.zeros((1, 2, 6), np.int32)
    ed = np.zeros((1, 2, 6), np.int32)
    ev = np.zeros((1, 2, 6), bool)
    for j, slot, u in ((1, 2, 3), (0, 5, 1), (1, 0, 2)):
        es[0, j, slot], ed[0, j, slot], ev[0, j, slot] = u, 2, True
    index = t_gather.gather_index(_t(es), _t(ed), _t(ev), n)
    assert index.row_ptr.tolist() == [0, 0, 0, 3, 3]
    assert index.src.tolist() == [0 * n + 1, 1 * n + 2, 1 * n + 3]


@pytest.fixture
def jgather():
    pytest.importorskip("jax")
    from repro.kernels.seg_gather import seg_gather_aggregate
    return seg_gather_aggregate


@pytest.mark.parametrize("op", ["max", "sum"])
@pytest.mark.parametrize("s,n,e,d,bb", [(2, 16, 24, 32, 16), (3, 8, 40, 16, 16),
                                        (2, 32, 64, 48, 16)])
def test_indexed_plain_walk_matches_pallas(jgather, op, s, n, e, d, bb):
    r = np.random.default_rng(s + n + e + d + 1)
    es, ed, ev = _edges(r, s, s, n, e)
    h = r.standard_normal((s, n, d), np.float32)
    exp = np.asarray(jgather(es, ed, ev, h, op=op, block_b=bb,
                             interpret=True))
    index = t_gather.gather_index(_t(es), _t(ed), _t(ev), n)
    out = ref.seg_gather_indexed(index, _t(h), op=op).numpy()
    if op == "max":
        np.testing.assert_array_equal(out, exp)
    else:
        np.testing.assert_allclose(out, exp, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("op", ["max", "sum"])
def test_indexed_destination_without_edges_is_zero(jgather, op):
    """Destination 0 of every shard has no in-edge and h is all negative:
    the indexed walk, the whole-function plain version and the Pallas
    kernel all write 0 there."""
    r = np.random.default_rng(31)
    es, ed, ev = _edges(r, 2, 2, 8, 16)
    ed = np.maximum(ed, 1)
    h = r.standard_normal((2, 8, 16), np.float32) - 5.0
    index = t_gather.gather_index(_t(es), _t(ed), _t(ev), 8)
    out = t_gather.seg_gather_aggregate(_t(es), _t(ed), _t(ev), _t(h), op=op,
                                        index=index).numpy()
    whole = ref.seg_gather(_t(es), _t(ed), _t(ev), _t(h), op=op).numpy()
    exp = np.asarray(jgather(es, ed, ev, h, op=op, block_b=16,
                             interpret=True))
    assert (out[:, 0] == 0).all() and (whole[:, 0] == 0).all()
    assert (exp[:, 0] == 0).all()
    np.testing.assert_allclose(out, whole, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(out, exp, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("op", ["max", "sum"])
def test_indexed_and_standalone_calls_agree(op):
    """With or without a kept index, and through the op on either
    backend, the same result (the reference backend ignores the index)."""
    r = np.random.default_rng(32)
    es, ed, ev = (_t(a) for a in _edges(r, 3, 2, 10, 30))
    h = _t(r.standard_normal((2, 10, 12), np.float32))
    index = t_gather.gather_index(es, ed, ev, 10)
    standalone = t_gather.seg_gather_aggregate(es, ed, ev, h, op=op)
    for out in (t_gather.seg_gather_aggregate(es, ed, ev, h, op=op,
                                              index=index),
                ops.gather_aggregate(es, ed, ev, h, op=op, index=index),
                ops.gather_aggregate(es, ed, ev, h, op=op, index=index,
                                     backend="reference")):
        assert out.shape == (3, 10, 12)
        torch.testing.assert_close(out, standalone, atol=1e-6, rtol=1e-6)


def test_index_on_another_device_is_refused():
    r = np.random.default_rng(33)
    es, ed, ev = (_t(a) for a in _edges(r, 2, 2, 4, 6))
    h = _t(r.standard_normal((2, 4, 3), np.float32))
    index = t_gather.gather_index(es, ed, ev, 4)
    meta = t_gather.GatherIndex(row_ptr=index.row_ptr.to("meta"),
                                src=index.src.to("meta"))
    with pytest.raises(ValueError, match="devices"):
        t_gather.seg_gather_aggregate(es, ed, ev, h, index=meta)


@pytest.mark.parametrize("normalize,loops", [("max", True), ("sum", False)])
def test_graph_tensors_carry_their_edges_index(normalize, loops):
    r = np.random.default_rng(34)
    num_nodes, n = 37, 16
    edges = r.integers(0, num_nodes, (120, 2)).astype(np.int64)
    sg = shard_graph(edges, num_nodes, n, normalize=normalize,
                     add_self_loops=loops)
    gt = GraphTensors.from_sharded(sg, "cpu")
    row_ptr, src = _numpy_index(sg.edge_src, sg.edge_dst, sg.edge_valid, n)
    np.testing.assert_array_equal(gt.gather_index.row_ptr.numpy(), row_ptr)
    np.testing.assert_array_equal(gt.gather_index.src.numpy(), src)
    # every edge of the graph (plus self loops) is in the index once
    assert int(gt.gather_index.row_ptr[-1]) == int(sg.edge_valid.sum())
