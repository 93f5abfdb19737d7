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
