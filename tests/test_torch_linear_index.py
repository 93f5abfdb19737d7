"""The destination-sorted index of the blocks' nonzeros (fused_gnn's and
shard_spmm's).

``csr.linear_index`` is held to the blocks it came from (scattering
``val`` back at (row, col) rebuilds them exactly; each row in (j, u)
order), the indexed plain walk ``ref.fused_gnn_indexed`` to the reference
package's Pallas kernel in interpret mode and to ``ref.fused_gnn`` on the
same numpy inputs (atol = rtol = 1e-4, float32 products), and the
registry and ``GraphTensors`` to passing the index through. The kernel
itself is held to these plain versions on the card
(tests/test_torch_kernels.py, ``cuda``).
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core.engines import GNNeratorController, GraphTensors
from repro_torch.core.sharding import shard_graph
from repro_torch.kernels import csr, ops, ref, registry
from repro_torch.kernels import fused_gnn as t_fused
from repro_torch.kernels import seg_gather as t_gather

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blocks(r, s, n, density, *, hub=True):
    """Random weighted blocks; destination shard 0 has no nonzero, and
    (with ``hub``) row 1 of shard 1 has nonzeros in every source shard."""
    a = np.where(r.random((s, s, n, n)) < density,
                 r.standard_normal((s, s, n, n)), 0.0).astype(np.float32)
    a[0] = 0.0
    if hub and s > 1:
        a[1, :, 1, : max(1, n // 3)] = 0.5
    return a


def _rebuild(index, s, n):
    rows = index.row_ptr.numel() - 1
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(rows), counts)
    dense = torch.zeros((rows, rows))
    dense[dst, index.col.long()] = index.val
    # (i·n + v, j·n + u) -> (i, j, v, u)
    return dense.reshape(s, n, s, n).permute(0, 2, 1, 3)


@pytest.mark.parametrize("s,n,density", [(2, 16, 0.2), (3, 8, 0.5),
                                         (3, 70, 0.05), (1, 5, 0.3)])
def test_linear_index_rebuilds_the_blocks(s, n, density):
    r = np.random.default_rng(s * 100 + n)
    a = _blocks(r, s, n, density)
    index = csr.linear_index(_t(a))
    assert index.row_ptr.dtype == torch.int32
    assert index.col.dtype == torch.int32
    assert index.val.dtype == torch.float32
    assert index.row_ptr.numel() == s * n + 1
    assert int(index.row_ptr[-1]) == int((a != 0).sum()) == index.col.numel()
    np.testing.assert_array_equal(_rebuild(index, s, n).numpy(), a)
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).numpy()
    assert index.hubs.dtype == torch.int32
    hubs = np.nonzero(counts > csr.HUB_ENTRIES)[0]
    np.testing.assert_array_equal(
        index.hubs.numpy(), hubs[np.argsort(-counts[hubs], kind="stable")])
    # (j, u) order in a row is increasing j·n + u
    for r0, r1 in zip(index.row_ptr[:-1].tolist(), index.row_ptr[1:].tolist()):
        cols = index.col[r0:r1]
        assert bool((cols[1:] > cols[:-1]).all())


def test_linear_index_covers_empty_and_hub_rows():
    """Shard 0 holds no nonzero: its rows are empty. Row 1 of shard 1
    holds nonzeros in every source shard, listed shard by shard."""
    s, n = 4, 12
    a = _blocks(np.random.default_rng(5), s, n, 0.1)
    index = csr.linear_index(_t(a))
    counts = (index.row_ptr[1:] - index.row_ptr[:-1]).numpy()
    assert (counts[:n] == 0).all()
    hub = n + 1
    cols = index.col[index.row_ptr[hub]:index.row_ptr[hub + 1]].numpy()
    assert sorted(set(cols // n)) == list(range(s))
    assert (np.diff(cols // n) >= 0).all()
    assert counts[hub] == counts.max()
    assert index.hubs.numel() == 0           # 4 x 4 entries: no hub


def test_linear_index_lists_the_hub_rows():
    """Rows of more than HUB_ENTRIES entries, and only those, longest
    first, rows of one length in row order."""
    s, n = 2, 40
    a = np.zeros((s, s, n, n), np.float32)
    a[1, :, 3, :] = 1.0                      # 80 entries: a hub
    a[0, 0, 7, : csr.HUB_ENTRIES] = 2.0      # exactly the limit: not one
    a[0, :, 9, :20] = 3.0                    # 40 entries: a hub
    a[0, :, 11, 20:] = 4.0                   # 40 entries: a hub
    index = csr.linear_index(_t(a))
    assert index.hubs.tolist() == [n + 3, 9, 11]


def test_linear_index_of_all_zero_blocks_is_empty():
    index = csr.linear_index(torch.zeros((2, 2, 3, 3)))
    assert index.row_ptr.tolist() == [0] * 7
    assert index.col.numel() == index.val.numel() == 0


def test_csr_is_the_one_home_of_both_formats():
    """seg_gather keeps its names importable; both are csr's."""
    assert t_gather.gather_index is csr.gather_index
    assert t_gather.GatherIndex is csr.GatherIndex
    assert t_fused.linear_index is csr.linear_index


@pytest.fixture
def jfused():
    pytest.importorskip("jax")
    from repro.kernels import registry as jreg
    from repro.kernels.fused_gnn import fused_gnn_layer
    return types.SimpleNamespace(kernel=fused_gnn_layer,
                                 pallas=jreg.get_backend("pallas"))


@pytest.mark.parametrize("activation", ["relu", "none"])
@pytest.mark.parametrize("s,n,d,f,bb", [(2, 16, 32, 8, 16), (3, 8, 64, 24, 16),
                                        (3, 70, 150, 16, 16)])
def test_indexed_fused_walk_matches_pallas(jfused, activation, s, n, d, f, bb):
    """The shapes of test_fused_gnn_matches_pallas, plus ragged n = 70 and
    D = 150 (the Pallas backend pads D to its block there)."""
    r = np.random.default_rng(s + n + d + f + 3)
    a = _blocks(r, s, n, 0.2)
    h = r.standard_normal((s, n, d), np.float32)
    w = r.standard_normal((d, f), np.float32)
    if d % bb == 0:
        exp = jfused.kernel(a, h, w, block_b=bb, activation=activation,
                            interpret=True)
    else:
        exp = jfused.pallas.fused_aggregate_extract(
            a, h, w, activation=activation, block_b=bb)
    index = csr.linear_index(_t(a))
    out = ref.fused_gnn_indexed(index, _t(h), _t(w), activation=activation)
    assert out.shape == (s, n, f)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)
    whole = ref.fused_gnn(_t(a), _t(h), _t(w), activation=activation)
    torch.testing.assert_close(out, whole, **TOL)


@pytest.mark.parametrize("activation", ["none", "relu", "gelu", "silu"])
def test_indexed_fused_walk_matches_whole_function(activation):
    r = np.random.default_rng(41)
    a = _blocks(r, 3, 20, 0.1)
    h = _t(r.standard_normal((3, 20, 7), np.float32))
    w = _t(r.standard_normal((7, 5), np.float32))
    index = csr.linear_index(_t(a))
    torch.testing.assert_close(
        ref.fused_gnn_indexed(index, h, w, activation=activation),
        ref.fused_gnn(_t(a), h, w, activation=activation), **TOL)


def test_fused_wrapper_with_and_without_index_agree():
    r = np.random.default_rng(42)
    a = _t(_blocks(r, 2, 10, 0.3))
    h = _t(r.standard_normal((2, 10, 6), np.float32))
    w = _t(r.standard_normal((6, 4), np.float32))
    index = csr.linear_index(a)
    standalone = t_fused.fused_gnn_layer(a, h, w, activation="relu")
    for out in (t_fused.fused_gnn_layer(a, h, w, activation="relu",
                                        index=index),
                ops.fused_aggregate_extract(a, h, w, activation="relu",
                                            index=index),
                ops.fused_aggregate_extract(a, h, w, activation="relu",
                                            index=index,
                                            backend="reference")):
        torch.testing.assert_close(out, standalone, atol=0, rtol=0)


def test_fused_index_on_another_device_is_refused():
    r = np.random.default_rng(43)
    a = _t(_blocks(r, 2, 4, 0.3))
    h = _t(r.standard_normal((2, 4, 3), np.float32))
    w = _t(r.standard_normal((3, 2), np.float32))
    index = csr.linear_index(a)
    meta = csr.LinearIndex(*(t.to("meta") for t in
                             (index.row_ptr, index.col, index.val,
                              index.hubs)))
    with pytest.raises(ValueError, match="devices"):
        t_fused.fused_gnn_layer(a, h, w, index=meta)


def test_registry_passes_the_index_to_the_kernel(monkeypatch):
    """The cuda backend hands ``index`` to the kernel wrapper; the
    reference backend runs the whole plain function and never reads it."""
    seen = {}

    def spy(blocks, h, w, *, activation="none", index=None):
        seen["index"] = index
        return ref.fused_gnn(blocks, h, w, activation=activation)

    monkeypatch.setattr(registry, "fused_gnn_layer", spy)
    r = np.random.default_rng(44)
    a = _t(_blocks(r, 2, 6, 0.3))
    h = _t(r.standard_normal((2, 6, 5), np.float32))
    w = _t(r.standard_normal((5, 3), np.float32))
    index = csr.linear_index(a)
    registry.resolve("cuda").fused_aggregate_extract(a, h, w, index=index)
    assert seen["index"] is index
    bogus = csr.LinearIndex(row_ptr=torch.zeros(1, dtype=torch.int32),
                            col=torch.zeros(0, dtype=torch.int32),
                            val=torch.zeros(0),
                            hubs=torch.zeros(0, dtype=torch.int32))
    out = registry.resolve("reference").fused_aggregate_extract(
        a, h, w, activation="relu", index=bogus)
    torch.testing.assert_close(
        out, ref.fused_gnn(a, h, w, activation="relu"), atol=0, rtol=0)


def _graph(normalize, loops):
    r = np.random.default_rng(45)
    num_nodes, n = 37, 16
    edges = r.integers(0, num_nodes, (120, 2)).astype(np.int64)
    sg = shard_graph(edges, num_nodes, n, normalize=normalize,
                     add_self_loops=loops)
    return sg, GraphTensors.from_sharded(sg, "cpu")


@pytest.mark.parametrize("normalize,loops", [("gcn", True), ("mean", False)])
def test_graph_tensors_carry_their_blocks_index(normalize, loops):
    sg, gt = _graph(normalize, loops)
    index = gt.linear_index
    assert gt.linear_index is index          # built once, kept
    np.testing.assert_array_equal(_rebuild(index, sg.S, sg.n).numpy(),
                                  sg.blocks)


def test_fused_layer_passes_the_graphs_index(monkeypatch):
    """graph_first (the fused gcn layer) hands the graph's kept index to
    the backend; the unfused layer hands the same kept index to
    graph_aggregate (shard_spmm walks it too), building it at its first
    call."""
    sg, gt = _graph("gcn", True)
    seen = []

    class Spy(registry.CudaBackend):
        def fused_aggregate_extract(self, blocks, h, w, *, activation="none",
                                    index=None):
            seen.append(("fused", index))
            return super().fused_aggregate_extract(
                blocks, h, w, activation=activation, index=index)

        def graph_aggregate(self, blocks, h, *, index=None):
            seen.append(("aggregate", index))
            return super().graph_aggregate(blocks, h, index=index)

    r = np.random.default_rng(46)
    h = gt.group(_t(r.standard_normal((sg.num_nodes, 6), np.float32)))
    w = _t(r.standard_normal((6, 4), np.float32))
    from repro_torch.core.engines import DenseEngine, GraphEngine
    spy = Spy()
    ctrl = GNNeratorController(dense=DenseEngine(spy), graph=GraphEngine(spy))
    unfused = GNNeratorController(dense=DenseEngine(spy),
                                  graph=GraphEngine(spy), fuse=False)
    assert "linear_index" not in gt.__dict__
    expect = unfused.graph_first(gt, h, w, activation="relu")
    index = gt.__dict__["linear_index"]
    assert [k for k, _ in seen] == ["aggregate"] and seen[0][1] is index
    out = ctrl.graph_first(gt, h, w, activation="relu")
    assert [k for k, _ in seen] == ["aggregate", "fused"]
    assert seen[1][1] is index and gt.linear_index is index
    torch.testing.assert_close(out, expect, **TOL)
