"""The port's large-graph datasets against the reference package's.

The power-law generator (``_powerlaw_edges``, used above
``_LARGE_GRAPH_EDGES`` target edges: reddit) must give bitwise the same
edges, features, labels and masks as ``repro.graphs.datasets`` for the
same seed and scale; it draws from the ``np.random.Generator`` in a fixed
order. Reddit stays at small scales here (0.01: 1.1 M edges; 0.05: 5.7 M)
and once at 0.1, the graph ``chip_smoke.py``'s phase 4h serves.
"""
import numpy as np
import pytest

from repro import graphs as jax_graphs
from repro.graphs import datasets as jax_datasets
from repro_torch import graphs
from repro_torch.graphs import datasets

FIELDS = ("edges", "features", "labels", "train_mask")


def _assert_same(ours, theirs):
    assert ours.profile.__dict__ == theirs.profile.__dict__
    for field in FIELDS:
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("scale", [0.01, 0.05])
def test_reddit_bitwise(scale):
    ours = datasets.make_dataset("reddit", seed=0, scale=scale)
    assert ours.profile.num_edges > datasets._LARGE_GRAPH_EDGES
    _assert_same(ours, jax_datasets.make_dataset("reddit", seed=0,
                                                 scale=scale))


@pytest.mark.parametrize("n,e_target,seed", [
    (2000, 100_000, 0),       # sparse: the heavy-tailed rounds only
    (300, 80_000, 1),         # near-saturated: uniform top-up, then stall
])
def test_powerlaw_edges_bitwise(n, e_target, seed, recwarn):
    ours = datasets._powerlaw_edges(n, e_target, np.random.default_rng(seed))
    theirs = jax_datasets._powerlaw_edges(n, e_target,
                                          np.random.default_rng(seed))
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    # both directions of each undirected edge, no self loop
    assert ours.shape[0] % 2 == 0 and (ours[:, 0] != ours[:, 1]).all()


def test_reddit_at_a_tenth_is_phase_4h_graph():
    ds = datasets.make_dataset("reddit", seed=0, scale=0.1)
    p = ds.profile
    assert (p.num_nodes, p.feature_dim, p.num_classes) == (23296, 602, 41)
    assert ds.edges.shape == (11_461_588, 2)
    deg = np.bincount(ds.edges[:, 1], minlength=p.num_nodes)
    assert deg.max() == 19_353
    assert abs(deg.mean() - 492.0) < 0.5


@pytest.mark.parametrize("name,seed,scale", [
    ("cora", 0, 0.1), ("pubmed", 2, 0.02), ("reddit", 1, 0.01)])
def test_load_matches_reference(name, seed, scale):
    ours = datasets.load(name, seed, scale=scale)
    theirs = jax_datasets.load(name, seed, scale=scale)
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    feats, labels, edges = ours
    assert feats.shape[0] == labels.shape[0] and edges.shape[1] == 2


@pytest.mark.parametrize("name", list(datasets.DATASETS))
def test_profiles_match_table2(name):
    """tests/test_core.py::test_profiles_match_table2 on the port."""
    p = datasets.DATASETS[name]
    scale = 1.0 if p.num_edges <= 1_000_000 else 0.05
    ds = datasets.make_dataset(name, scale=scale)
    assert ds.features.shape == (ds.profile.num_nodes, p.feature_dim)
    # edge count within 2% of the (scaled) Table II target
    assert (abs(ds.edges.shape[0] - ds.profile.num_edges)
            / ds.profile.num_edges < 0.02)


def test_profiles_equal_reference():
    for ours, theirs in ((datasets.DATASETS, jax_datasets.DATASETS),
                         (datasets.LARGE_DATASETS,
                          jax_datasets.LARGE_DATASETS),
                         (datasets.TABLE2_DATASETS,
                          jax_datasets.TABLE2_DATASETS)):
        assert {k: v.__dict__ for k, v in ours.items()} == \
            {k: v.__dict__ for k, v in theirs.items()}
    assert datasets._LARGE_GRAPH_EDGES == jax_datasets._LARGE_GRAPH_EDGES


def test_graphs_exports():
    from repro_torch.graphs import sampler

    assert set(jax_graphs.__all__) <= set(graphs.__all__)
    for name in graphs.__all__:
        assert getattr(graphs, name) is not None, name
    assert graphs.NeighborSampler is sampler.NeighborSampler
    assert graphs.SubgraphBatch is sampler.SubgraphBatch
    assert graphs.load is datasets.load
    assert graphs.LARGE_DATASETS is datasets.LARGE_DATASETS
