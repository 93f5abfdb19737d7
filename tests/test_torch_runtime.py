"""The port's host code and runtime against the reference package.

Datasets and sharding must be bitwise equal, plans JSON-equal, and a
compiled Executable must predict what the reference Executable predicts
on the same graph and parameters; parameter files cross between the two
packages in the flat npz layout.
"""
import jax
import numpy as np
import pytest
import torch

from repro import runtime as jax_runtime
from repro.core.sharding import shard_graph as jax_shard_graph
from repro.gnn.executor import plan_model as jax_plan_model
from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo
from repro.graphs.datasets import make_dataset as jax_make_dataset
from repro_torch import runtime
from repro_torch.core.sharding import shard_graph
from repro_torch.gnn.executor import plan_model
from repro_torch.gnn.models import ZooSpec, init_params, params_from_numpy
from repro_torch.graphs.datasets import TABLE2_DATASETS, make_dataset

ARCHS = ("gcn", "sage_mean", "sage_max")


@pytest.mark.parametrize("name,seed,scale", [
    ("cora", 0, 0.1), ("citeseer", 3, 0.05), ("pubmed", 1, 0.02)])
def test_make_dataset_bitwise(name, seed, scale):
    ours = make_dataset(name, seed=seed, scale=scale)
    theirs = jax_make_dataset(name, seed=seed, scale=scale)
    assert ours.profile.__dict__ == theirs.profile.__dict__
    for field in ("edges", "features", "labels", "train_mask"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("normalize,loops", [
    ("gcn", True), ("mean", True), ("sum", True), ("sum", False)])
def test_shard_graph_bitwise(normalize, loops):
    g = make_dataset("cora", seed=0, scale=0.1)
    ours = shard_graph(g.edges, g.profile.num_nodes, 64, normalize=normalize,
                       add_self_loops=loops)
    theirs = jax_shard_graph(g.edges, g.profile.num_nodes, 64,
                             normalize=normalize, add_self_loops=loops)
    assert (ours.S, ours.n, ours.num_edges) == \
        (theirs.S, theirs.n, theirs.num_edges)
    for field in ("blocks", "edge_src", "edge_dst", "edge_valid", "degrees"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


@pytest.mark.parametrize("dataset", sorted(TABLE2_DATASETS))
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_model_json_equal(dataset, arch):
    """Full-size Table-II profiles: planning needs no graph, only sizes."""
    p = TABLE2_DATASETS[dataset]
    dims = (p.feature_dim, 16, p.num_classes)
    for max_n in (1024, 512):
        ours = plan_model(ZooSpec(arch, *dims), p.num_nodes, p.num_edges,
                          max_n=max_n)
        theirs = jax_plan_model(JaxSpec(arch, *dims), p.num_nodes,
                                p.num_edges, max_n=max_n)
        assert ours.to_json() == theirs.to_json()
        assert ours.shard_n == theirs.shard_n


def _jax_params(arch, prof, seed=0):
    spec = JaxSpec(arch, prof.feature_dim, 16, prof.num_classes)
    return spec, init_zoo(jax.random.key(seed), spec)


@pytest.fixture(scope="module")
def cora():
    return make_dataset("cora", seed=0, scale=0.1)


@pytest.mark.parametrize("arch", ARCHS)
def test_compile_predict_matches_reference(cora, arch):
    prof = cora.profile
    jspec, jparams = _jax_params(arch, prof)
    jexe = jax_runtime.compile(jspec, cora, backend="reference",
                               params=jparams)
    exe = runtime.compile(ZooSpec(arch, prof.feature_dim, 16,
                                  prof.num_classes),
                          cora, device="cpu",
                          params=jax.tree_util.tree_map(np.asarray, jparams))
    assert exe.plan.to_json() == jexe.plan.to_json()
    ids = np.arange(0, prof.num_nodes, 7)
    jcls, jprob = jexe.predict(ids)
    cls, prob = exe.predict(ids)
    np.testing.assert_array_equal(cls, jcls)
    np.testing.assert_allclose(prob, jprob, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(exe.forward_nodes(ids[:5]).numpy(),
                               np.asarray(jexe.forward_nodes(ids[:5])),
                               atol=1e-4, rtol=1e-4)


def test_jax_checkpoint_loads_into_port_and_back(cora, tmp_path):
    prof = cora.profile
    jspec, jparams = _jax_params("sage_max", prof, seed=5)
    jexe = jax_runtime.compile(jspec, cora, backend="reference",
                               params=jparams)
    path = tmp_path / "params.npz"
    jexe.save_params(path)

    exe = runtime.compile(ZooSpec("sage_max", prof.feature_dim, 16,
                                  prof.num_classes), cora, device="cpu")
    exe.full_probs()
    exe.load_params(path)
    assert not exe.has_cached_probs
    np.testing.assert_allclose(exe.forward().numpy(),
                               np.asarray(jexe.forward()),
                               atol=1e-4, rtol=1e-4)

    back = tmp_path / "port.npz"
    exe.save_params(back)
    with np.load(path) as a, np.load(back) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_load_params_rejects_other_shapes(cora, tmp_path):
    prof = cora.profile
    exe = runtime.compile(ZooSpec("gcn", prof.feature_dim, 16,
                                  prof.num_classes), cora, device="cpu")
    other = runtime.compile(ZooSpec("gcn", prof.feature_dim, 8,
                                    prof.num_classes), cora, device="cpu")
    path = tmp_path / "other.npz"
    other.save_params(path)
    with pytest.raises(ValueError, match="shape mismatch"):
        exe.load_params(path)


def test_params_from_numpy_keeps_tree_and_values():
    spec = JaxSpec("sage_max", 12, 8, 3)
    tree = jax.tree_util.tree_map(np.asarray, init_zoo(jax.random.key(1), spec))
    out = params_from_numpy(tree, "cpu")
    assert isinstance(out["layers"], list) and len(out["layers"]) == 2
    for layer, ref_layer in zip(out["layers"], tree["layers"]):
        assert layer.keys() == ref_layer.keys()
        for k, v in layer.items():
            assert v.dtype == torch.float32 and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), ref_layer[k])
    # tensors pass through, numpy views are copied (not shared)
    again = params_from_numpy(out, "cpu")
    assert torch.equal(again["layers"][0]["w"], out["layers"][0]["w"])
    arr = np.ones((2, 2), np.float32)
    t = params_from_numpy(arr, "cpu")
    arr[0, 0] = 5.0
    assert t[0, 0].item() == 1.0


def test_init_params_is_seeded_and_shaped():
    spec = ZooSpec("sage_max", 12, 8, 3)
    a = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    b = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    c = init_params(spec, torch.Generator().manual_seed(1), "cpu")
    ref = jax.tree_util.tree_map(np.shape,
                                 init_zoo(jax.random.key(0),
                                          JaxSpec("sage_max", 12, 8, 3)))
    for la, lb, lc, lr in zip(a["layers"], b["layers"], c["layers"],
                              ref["layers"]):
        for k in lr:
            assert tuple(la[k].shape) == lr[k]
            assert torch.equal(la[k], lb[k])
        assert not torch.equal(la["w"], lc["w"])


def test_graph_store_shares_builds_per_signature(cora):
    prof = cora.profile
    store = runtime.GraphStore()
    for arch in ("sage_max", "sage_max", "gcn"):
        runtime.compile(ZooSpec(arch, prof.feature_dim, 16, prof.num_classes),
                        cora, device="cpu", store=store, graph_key="cora")
    assert store.stats["misses"] == 2 and store.stats["hits"] == 1
    assert len(store) == 2
    store.evict("cora")
    assert len(store) == 0
