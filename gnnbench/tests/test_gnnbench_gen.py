"""The benchmark's frozen graph generator gives bitwise what the
program's gives for one seed."""
import numpy as np
import pytest

from gnnbench.harness import gen
from repro_torch.graphs.datasets import make_dataset


@pytest.mark.parametrize("name,scale,seed", [
    ("pubmed", 1.0, 0), ("pubmed", 1.0, 2 ** 31 + 5), ("reddit", 0.01, 7),
    ("cora", 0.5, 3)])
def test_graph_equals_make_dataset(name, scale, seed):
    ours = gen.make_graph(name, seed=seed, scale=scale)
    theirs = make_dataset(name, seed=seed, scale=scale)
    assert ours.name == theirs.profile.name
    assert (ours.num_nodes, ours.num_edges, ours.feature_dim,
            ours.num_classes) == (theirs.profile.num_nodes,
                                  theirs.profile.num_edges,
                                  theirs.profile.feature_dim,
                                  theirs.profile.num_classes)
    for field in ("edges", "features", "labels", "train_mask"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_every_seed_gets_the_same_graph_in_another_order():
    """The driver's graph is the configuration's, drawn from GRAPH_SEED,
    its nodes relabelled by the run's seed: the same work for every
    seed, and the same inputs for one seed."""
    import types

    from gnnbench.harness.drive import Driver

    cell = types.SimpleNamespace(
        config={"dataset": "cora", "scale": 0.5, "num_nodes": 1354,
                "num_edges": 5278, "feature_dim": 1433, "num_classes": 7,
                "num_layers": 2, "hidden_dim": 16},
        reference=types.SimpleNamespace(param_shapes=lambda d, c: []),
        traffic={}, metrics_of=lambda kind: [])
    graphs = []
    for seed in (5, 2 ** 31 + 7, 5):
        driver = Driver(cell, seed, 1.0, "cpu", False, 0.0)
        driver.build_graph()
        graphs.append(driver.graph)
    a, b, again = graphs
    plain = gen.make_graph("cora", seed=gen.GRAPH_SEED, scale=0.5)
    for g in (a, b):
        deg = np.bincount(g.edges[:, 1], minlength=g.num_nodes)
        assert sorted(deg) == sorted(np.bincount(plain.edges[:, 1],
                                                 minlength=plain.num_nodes))
        assert sorted(map(tuple, g.features.round(6).tolist())) == \
            sorted(map(tuple, plain.features.round(6).tolist()))
    assert not np.array_equal(a.edges, b.edges)
    for field in ("edges", "features", "labels", "train_mask"):
        assert np.array_equal(getattr(a, field), getattr(again, field))
    # the relabelling keeps each node's row with its edges
    perm = np.random.default_rng([5, 3]).permutation(plain.num_nodes)
    assert np.array_equal(a.edges, perm[plain.edges])
    assert np.array_equal(a.labels[perm], plain.labels)
