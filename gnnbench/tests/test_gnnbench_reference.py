"""The benchmark's plain GCN agrees with the port's ``reference``
backend on a small graph, before and after deltas, given each layer's
parameters whole; the weights drawn from the reference's declared shapes
equal the GCN draw they replaced, bit for bit; the count functions equal
hand counts; the comparison's error behaves as documented."""
import numpy as np
import pytest
import torch

from gnnbench.counts import gcn as counts
from gnnbench.harness import gen
from gnnbench.harness.check import entry_errors, verdict
from gnnbench.harness.drive import graph_nnz, make_weights
from gnnbench.harness.peaks import H100_SXM
from gnnbench.reference import gcn as ref
from repro_torch import runtime
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import GraphData, GraphProfile
from repro_torch.graphs.delta import apply_to_graph_data
from repro_torch.stream.workload import random_delta


def _port_logits(g, edges, weights):
    data = GraphData(GraphProfile("t", g.num_nodes, len(edges),
                                  g.feature_dim, g.num_classes),
                     edges.copy(), g.features, g.labels, g.train_mask)
    spec = ZooSpec("gcn", g.feature_dim, 16, g.num_classes, num_layers=2)
    exe = runtime.compile(spec, data, device="cpu", backend="reference",
                          params=weights, max_shard_n=64,
                          store=runtime.GraphStore())
    return exe.forward().numpy()


@pytest.mark.parametrize("seed", [0, 5])
def test_reference_matches_the_port_before_and_after_deltas(seed):
    """The reference works Â out again from whatever edge list it is
    given: the port's own deltas leave that list directed, with pairs
    gone and added, and the two still agree."""
    g = gen.make_graph("pubmed", seed=seed, scale=0.02)
    dims = [g.feature_dim, 16, g.num_classes]
    w = make_weights(ref.param_shapes(dims, {}), 1, seed, "cpu")[0]
    rng = np.random.default_rng(seed)
    data = GraphData(GraphProfile("t", g.num_nodes, len(g.edges),
                                  g.feature_dim, g.num_classes),
                     g.edges.copy(), g.features, g.labels, g.train_mask)
    for step in range(4):
        ours = ref.logits(ref.adjacency(data.edges, g.num_nodes, "cpu"),
                          torch.as_tensor(g.features), w["layers"]).numpy()
        theirs = _port_logits(g, data.edges, w)
        np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
        apply_to_graph_data(data, random_delta(data, rng, edge_ops=8,
                                               p_delete=0.5))
    # deltas leave the graph directed: the normalization reads both degrees
    keys = set(gen.pair_keys(data.edges).tolist())
    assert any(((v << 32) | u) not in keys for u, v in data.edges.tolist())


def _gcn_weights_as_drawn_before(dims, sets, seed, device):
    """The GCN draw that ``make_weights`` replaced, frozen: one flat
    ``torch.randn`` cut into (d, f) matrices, each Glorot normal."""
    gen_ = torch.Generator(device=device)
    gen_.manual_seed(seed % 2 ** 64)
    shapes = list(zip(dims[:-1], dims[1:]))
    per_set = sum(d * f for d, f in shapes)
    flat = torch.randn(sets * per_set, generator=gen_, device=device)
    trees, off = [], 0
    for _ in range(sets):
        layers = []
        for d, f in shapes:
            w = flat[off:off + d * f].view(d, f) * (2.0 / (d + f)) ** 0.5
            layers.append({"w": w.contiguous()})
            off += d * f
        trees.append({"layers": layers})
    return trees


@pytest.mark.parametrize("dims", [[602, 16, 41], [500, 16, 3]])
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5])
def test_gcn_weights_are_the_draw_they_replaced(seed, dims):
    ours = make_weights(ref.param_shapes(dims, {}), 2, seed, "cpu")
    theirs = _gcn_weights_as_drawn_before(dims, 2, seed, "cpu")
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        assert [list(layer) for layer in a["layers"]] == [["w"], ["w"]]
        for la, lb in zip(a["layers"], b["layers"]):
            assert la["w"].dtype == lb["w"].dtype
            assert torch.equal(la["w"], lb["w"])


def test_weights_draw_every_declared_tensor():
    """Biases and a rank-0 ε are drawn like the rest, so none is zero; a
    rank-0 tensor is scaled by ``SCALAR_SCALE``, the others Glorot."""
    from gnnbench.harness.drive import SCALAR_SCALE

    shapes = [{"eps": (), "w1": (6, 4), "b1": (4,)}, {"w": (4, 2)}]
    tree, = make_weights(shapes, 1, 3, "cpu")
    flat = torch.randn(37, generator=torch.Generator().manual_seed(3))
    eps, w1, b1 = (tree["layers"][0][k] for k in ("eps", "w1", "b1"))
    assert eps.shape == () and torch.equal(eps, flat[0] * SCALAR_SCALE)
    assert torch.equal(w1, flat[1:25].view(6, 4) * (2.0 / 10) ** 0.5)
    assert torch.equal(b1, flat[25:29] * (2.0 / 8) ** 0.5)
    assert bool((b1 != 0).all()) and float(eps) != 0.0
    assert tree["layers"][1]["w"].shape == (4, 2)


def test_counts_equal_hand_counts():
    # 3 nodes, edges 0->1, 1->0, 1->2: with self loops Â has 6 nonzeros
    edges = np.array([[0, 1], [1, 0], [1, 2], [1, 2]])
    assert graph_nnz(edges, 3) == 6
    # D 4 -> F 2: Â·(H·W), the aggregation at the narrower F
    assert counts.layer_flops(3, 6, 4, 2) == 2 * 6 * 2 + 2 * 3 * 4 * 2
    # D 4 -> F 16: (Â·H)·W, the aggregation at D
    assert counts.layer_flops(3, 6, 4, 16) == 2 * 6 * 4 + 2 * 3 * 4 * 16
    assert counts.layer_bytes(3, 6, 4, 2) == 4 * (4 + 12 + 12 + 8 + 6)
    layers = counts.network_layers(3, 6, [4, 16, 2])
    assert layers == [(3, 6, 4, 16), (3, 6, 16, 2)]
    b0 = max(counts.layer_bytes(3, 6, 4, 16) / 3.35e12,
             counts.layer_flops(3, 6, 4, 16) / 67e12)
    b1 = max(counts.layer_bytes(3, 6, 16, 2) / 3.35e12,
             counts.layer_flops(3, 6, 16, 2) / 67e12)
    assert counts.network_bound_s(3, 6, [4, 16, 2], H100_SXM) == \
        pytest.approx(b0 + b1, rel=1e-12)


def test_reddit01_layer0_bound_is_its_operations():
    """Layer 0 of reddit x0.1 (23,296 rows, 11,484,884 nonzeros, D 602 ->
    F 16): its operations are counted at the cheaper association, the
    aggregation at F 16 (0.82 GFLOP, not the 13.8 of aggregating at D
    602), so the bound is its bytes (149.6 MB at 3.35 TB/s)."""
    rows, nnz, d, f = 23296, 11484884, 602, 16
    assert counts.layer_flops(rows, nnz, d, f) == \
        2 * nnz * 16 + 2 * rows * 602 * 16
    s = counts.layer_bound_s(rows, nnz, d, f, H100_SXM)
    assert counts.layer_flops(rows, nnz, d, f) / 67e12 < s
    assert counts.layer_bytes(rows, nnz, d, f) / 3.35e12 == s
    assert 0.044e-3 < s < 0.045e-3
    # the aggregation runs at the narrower width whichever side it is on
    assert counts.layer_flops(rows, nnz, 16, 41) == \
        2 * nnz * 16 + 2 * rows * 16 * 41


def test_entry_errors_and_verdict():
    p = np.array([[0.5, 0.3, 0.2], [0.1, 0.2, 0.7]])
    err = entry_errors(p, np.array([0, 2]), np.array([0.5, 0.7]))
    assert err.tolist() == [0.0, 0.0]
    err = entry_errors(p, np.array([1, 2]), np.array([0.3, 0.71]))
    assert err[0] == pytest.approx(0.2 / 0.5)
    assert err[1] == pytest.approx(0.01 / 0.7)
    assert entry_errors(p, np.array([5, 0]), np.array([1.0, 0.1]))[0] == 1.0
    ok, table = verdict({"answer_err": 2e-6, "unanswered": 0},
                        {"answer_err": 1e-5, "unanswered": 0})
    assert ok and table["answer_err"] == {"value": 2e-6, "limit": 1e-5}
    ok, _ = verdict({"answer_err": float("inf"), "unanswered": 0},
                    {"answer_err": 1e-5, "unanswered": 0})
    assert not ok
