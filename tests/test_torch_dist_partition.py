"""The port's partitioner against ``repro.graphs.partition``, bitwise.

Both sides take the same numpy shard grid (the reference's
``shard_graph``) and must give the same plan: every array of the
:class:`PartitionPlan` (dtype and values), every scalar, and every byte
model. The port also plans over its device-side ``GraphTensors``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.sharding import shard_graph as jax_shard_graph
from repro.graphs import partition as ref_part
from repro.graphs.datasets import make_dataset as jax_make_dataset
from repro_torch.core.engines import GraphTensors
from repro_torch.core.sharding import shard_graph
from repro_torch.graphs import partition as port_part

GRAPHS = {"cora": 1.0, "citeseer": 1.0, "pubmed": 0.15}
SHARD_N = 256
FENNEL = [(hub, slack) for hub in (0, 64, 256) for slack in (0.0, 0.25)]


@pytest.fixture(scope="module")
def grids():
    out = {}
    for name, scale in GRAPHS.items():
        ds = jax_make_dataset(name, seed=0, scale=scale)
        out[name] = (ds, jax_shard_graph(ds.edges, ds.profile.num_nodes,
                                         SHARD_N))
    return out


def assert_same_plan(a, b):
    """Every field and byte model of two PartitionPlans, bitwise."""
    assert type(a).__name__ == type(b).__name__ == "PartitionPlan"
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray) and isinstance(y, np.ndarray), \
                f.name
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert np.array_equal(x, y), f.name
        else:
            assert x == y and type(x) is type(y), f.name
    for attr in ("total_edges", "cross_group_edge_frac", "hub_rows",
                 "edge_imbalance"):
        assert getattr(a, attr) == getattr(b, attr), attr
    for d in (1, 8, 250, 1433):
        for kw in ({}, {"dtype_bytes": 4}):
            assert a.transfer_bytes_per_layer(d, **kw) == \
                b.transfer_bytes_per_layer(d, **kw)
            assert a.transfer_bytes_per_layer(d, dedup=False, **kw) == \
                b.transfer_bytes_per_layer(d, dedup=False, **kw)
            assert a.allgather_bytes_per_layer(d, SHARD_N, **kw) == \
                b.allgather_bytes_per_layer(d, SHARD_N, **kw)
            assert a.hub_bytes_per_layer(d, **kw) == \
                b.hub_bytes_per_layer(d, **kw)


@pytest.mark.parametrize("n_data", [1, 2, 4])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_partition_matches_reference(grids, graph, n_data):
    _, sg = grids[graph]
    for pad in (False, True):
        assert_same_plan(
            ref_part.partition_graph(sg, n_data, pad=pad),
            port_part.partition_graph(sg, n_data, pad=pad))
    for hub, slack in FENNEL:
        kw = dict(method="fennel", hub_cache=hub, slack=slack)
        ref = ref_part.partition_graph(sg, n_data, **kw)
        assert_same_plan(ref, port_part.partition_graph(sg, n_data, **kw))
        if n_data > 1 and hub:
            # the never-worse guarantee the comm contract's CC005 checks
            base = ref_part.partition_graph(sg, n_data, pad=True)
            assert ref.cross_group_edge_frac <= \
                base.cross_group_edge_frac + 1e-9
    for method, hub in (("contiguous", 0), ("fennel", 0), ("fennel", 256)):
        assert ref_part.balance_report(sg, n_data, method=method,
                                       hub_cache=hub) == \
            port_part.balance_report(sg, n_data, method=method,
                                     hub_cache=hub)


@pytest.mark.parametrize("graph", ["cora", "pubmed"])
def test_partition_over_graph_tensors(grids, graph):
    """The port plans over its device tensors (read back to the host)
    exactly as over the numpy grid."""
    ds, sg = grids[graph]
    tsg = shard_graph(ds.edges, ds.profile.num_nodes, SHARD_N)
    gt = GraphTensors.from_sharded(tsg, "cpu")
    assert isinstance(gt.blocks, torch.Tensor)
    assert np.array_equal(gt.occupancy, sg.occupancy)
    for kw in ({"pad": True}, {"method": "fennel", "hub_cache": 64}):
        assert_same_plan(ref_part.partition_graph(sg, 4, **kw),
                         port_part.partition_graph(gt, 4, **kw))


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_warm_start_matches_reference(grids, graph):
    """The streaming re-partition: warm start from a previous placement,
    re-place the refined vertices, under the pinned capacities."""
    _, sg = grids[graph]
    rng = np.random.default_rng(0)
    kw = dict(method="fennel", hub_cache=64, slack=0.25)
    first = ref_part.partition_graph(sg, 4, **kw)
    refine = rng.choice(sg.S * sg.n, size=97, replace=False)
    for refine_nodes in (refine, None, np.empty(0, np.int64)):
        warm = dict(kw, prev_groups=first.node_group,
                    refine_nodes=refine_nodes, hub_cap=first.hub_cap,
                    halo_cap=first.halo_cap)
        assert_same_plan(ref_part.partition_graph(sg, 4, **warm),
                         port_part.partition_graph(sg, 4, **warm))


@pytest.mark.parametrize("which", ["halo", "hub"])
def test_pinned_caps_overflow_raises(grids, which):
    _, sg = grids["cora"]
    plan = ref_part.partition_graph(sg, 4, method="fennel", hub_cache=256)
    caps = {"hub_cap": plan.hub_cap, "halo_cap": plan.halo_cap}
    caps[f"{which}_cap"] -= 1
    for mod in (ref_part, port_part):
        with pytest.raises(ValueError, match=f"{which}.*recompile required"):
            mod.partition_graph(sg, 4, method="fennel", hub_cache=256,
                                **caps)
    # the caps that were compiled still fit
    assert_same_plan(
        ref_part.partition_graph(sg, 4, method="fennel", hub_cache=256,
                                 hub_cap=plan.hub_cap,
                                 halo_cap=plan.halo_cap),
        port_part.partition_graph(sg, 4, method="fennel", hub_cache=256,
                                  hub_cap=plan.hub_cap,
                                  halo_cap=plan.halo_cap))


def test_unknown_method_raises(grids):
    _, sg = grids["cora"]
    with pytest.raises(ValueError, match="method must be"):
        port_part.partition_graph(sg, 2, method="metis")


def test_small_grids_match_reference():
    """The reference's regression shapes: a 4-row grid over 3 groups
    (balanced, no empty group) and a 5-row grid padded over 4."""
    rng = np.random.default_rng(0)
    for nodes, n, n_data in ((512, 128, 3), (640, 128, 4), (512, 64, 4)):
        edges = rng.integers(0, nodes, (4000, 2))
        sg = jax_shard_graph(edges, nodes, n)
        for kw in ({}, {"pad": True},
                   {"method": "fennel", "hub_cache": 16, "slack": 0.25}):
            assert_same_plan(ref_part.partition_graph(sg, n_data, **kw),
                             port_part.partition_graph(sg, n_data, **kw))
        assert ref_part.balance_report(sg, n_data) == \
            port_part.balance_report(sg, n_data)
