"""Sharded GNN execution on a ``LocalMesh``: parity with the JAX
single-device ``Executable``, and the counted communication against the
reference's recorded volumes.

The reference checks its sharded forward on 8 virtual XLA devices; tier-1
runs JAX on one CPU device, so the JAX side here is its single-device
``Executable`` on the same numpy parameters (the check of the
reference's ``tests/test_dist_exec.py``), and the port's sharded forward
runs every rank of the mesh in this process.
"""
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import runtime as jax_runtime
from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo
from repro_torch import runtime
from repro_torch.analyze.comm_lint import (check_comm_stats,
                                           check_partition_quality,
                                           check_sharded_executable)
from repro_torch.dist.gnn import ShardedExecutable
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.graphs.partition import partition_graph
from repro_torch.launch.mesh import make_mesh_for

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
MESHES = [(1, 1), (2, 1), (4, 2)]
ARCHS = ("gcn", "sage_mean", "gin")


def _mesh(n_data, n_model):
    return make_mesh_for(n_data * n_model, model_parallel=n_model,
                         device="cpu")


@pytest.fixture(scope="module")
def cora_half():
    return make_dataset("cora", seed=0, scale=0.5)


@pytest.fixture(scope="module")
def jax_single(cora_half):
    """Per arch: (numpy params, the JAX single-device logits) at cora 0.5,
    shards of at most 128 nodes, hidden 8, the reference backend."""
    out = {}
    prof = cora_half.profile
    for arch in ARCHS:
        jspec = JaxSpec(arch, prof.feature_dim, 8, prof.num_classes)
        params = jax.tree_util.tree_map(
            np.asarray, init_zoo(jax.random.key(7), jspec))
        exe = jax_runtime.compile(jspec, cora_half, backend="reference",
                                  max_shard_n=128, params=params)
        out[arch] = (params, np.asarray(exe.forward()))
    return out


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("partition", ["contiguous", "fennel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_forward_matches_jax_single_device(cora_half, jax_single,
                                                   arch, partition,
                                                   mesh_shape):
    params, expect = jax_single[arch]
    prof = cora_half.profile
    exe = runtime.compile(ZooSpec(arch, prof.feature_dim, 8,
                                  prof.num_classes), cora_half,
                          device="cpu", backend="reference", max_shard_n=128,
                          params=params, mesh=_mesh(*mesh_shape),
                          partition=partition, hub_cache=128)
    assert isinstance(exe, ShardedExecutable)
    assert exe.partition.method == partition
    got = exe.forward()
    assert got.shape == expect.shape == (prof.num_nodes, prof.num_classes)
    np.testing.assert_allclose(got.numpy(), expect, **TOL)
    # the serving entry points ride the same forward
    ids = [0, 7, prof.num_nodes - 1]
    classes, _ = exe.predict(ids)
    np.testing.assert_array_equal(classes, expect[ids].argmax(-1))
    cs = exe.verify_comm(rtol=0.0)
    n_data, n_model = mesh_shape
    layers = len(exe.spec.layer_dims)
    if n_data == 1:
        assert "all-gather" not in cs["measured_counts"]
    elif partition == "fennel":
        # layer 0 reads its replicated input: hub + halo on later layers
        assert cs["measured_counts"]["all-gather"] == 2 * (layers - 1)
    else:
        assert cs["measured_counts"]["all-gather"] == layers
    psums = layers * (2 if arch == "gin" else 1)
    assert cs["measured_counts"].get("all-reduce", 0) == \
        (psums if n_model > 1 else 0)


@pytest.mark.parametrize("mesh_shape", [(2, 1), (4, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_cuda_backend_plain_versions_match_reference(cora_half, jax_single,
                                                     mesh_shape):
    """The default ``cuda`` backend (its plain versions on CPU tensors,
    each data group's kept index passed through) gives the same logits."""
    params, expect = jax_single["sage_mean"]
    prof = cora_half.profile
    exe = runtime.compile(ZooSpec("sage_mean", prof.feature_dim, 8,
                                  prof.num_classes), cora_half,
                          device="cpu", max_shard_n=128, params=params,
                          mesh=_mesh(*mesh_shape), partition="fennel",
                          hub_cache=64)
    assert exe.backend_name == "cuda"
    np.testing.assert_allclose(exe.forward().numpy(), expect, **TOL)
    idx = exe.group_indexes()
    assert len(idx) == mesh_shape[0]
    assert exe.group_indexes() is idx          # kept, not rebuilt
    rows = exe.rows_per_device * exe.gt.n
    assert all(i.row_ptr.numel() == rows + 1 for i in idx)


def _dist_rows():
    return json.loads((ROOT / "BENCH_gnn.json").read_text())[
        "dist_scaling"]["rows"]


@pytest.fixture(scope="module")
def full_graphs():
    return {}


@pytest.mark.parametrize("row", _dist_rows(),
                         ids=lambda r: f"{r['graph']}-{r['arch']}-"
                                       f"{r['partition']}")
def test_counted_bytes_equal_recorded_dist_scaling(full_graphs, row):
    """The reference's recorded volumes (``BENCH_gnn.json``
    ``dist_scaling``: full cora and citeseer, data 4 x model 2,
    ``max_shard_n=256``, hub_cache 256) are properties of the program:
    the port's counted bytes and its plan equal them exactly, and the
    comm contract (CC001-CC005) holds."""
    meta = json.loads((ROOT / "BENCH_gnn.json").read_text())["dist_scaling"]
    mesh = make_mesh_for(meta["devices"],
                         model_parallel=meta["mesh"]["model"], device="cpu")
    if row["graph"] not in full_graphs:
        full_graphs[row["graph"]] = make_dataset(row["graph"], seed=0)
    ds = full_graphs[row["graph"]]
    prof = ds.profile
    exe = runtime.compile(ZooSpec(row["arch"], prof.feature_dim, 16,
                                  prof.num_classes), ds, device="cpu",
                          backend="reference", max_shard_n=256, mesh=mesh,
                          partition=row["partition"],
                          hub_cache=meta["hub_cache"])
    cs = exe.comm_stats()
    assert cs["measured_allgather_wire_bytes"] == row["allgather_wire_bytes"]
    assert cs["measured_wire_bytes"]["all-reduce"] == \
        row["allreduce_wire_bytes"]
    assert round(cs["cross_group_edge_frac"], 4) == \
        row["cross_group_edge_frac"]
    assert round(exe.partition.edge_imbalance, 3) == row["imbalance"]
    assert sum(cs["plan_transfer_bytes_per_layer"].values()) == \
        row["plan_edge_pull_bound_bytes"]
    if row["partition"] == "fennel":
        assert (cs["hub_rows"], cs["hub_cap"], cs["halo_cap"]) == \
            (row["hub_rows"], row["hub_cap"], row["halo_cap"])
    findings = check_comm_stats(cs, rtol=0.0)
    findings += check_partition_quality(
        exe.partition, partition_graph(exe.gt, exe.n_data, pad=True))
    assert not [f for f in findings if f.severity != "info"], findings
    assert [f.rule for f in findings] == ["CC005"]


def test_permuted_grid_equals_the_dense_gather(cora_half):
    """The fennel grid is built from the nonzeros; the reference gathers
    the densified (N+1)^2 matrix's rows and columns by slot. Same values,
    bitwise."""
    prof = cora_half.profile
    exe = runtime.compile(ZooSpec("gcn", prof.feature_dim, 8,
                                  prof.num_classes), cora_half, device="cpu",
                          backend="reference", max_shard_n=128,
                          mesh=_mesh(4, 1), partition="fennel", hub_cache=64)
    gt, sp, n = exe.gt, exe.S_pad, exe.gt.n
    dense = gt.blocks.permute(0, 2, 1, 3).reshape(gt.S * n, gt.S * n)
    dense = torch.nn.functional.pad(dense, (0, 1, 0, 1))
    perm = exe.partition.perm
    idx = torch.as_tensor(np.where(perm < 0, gt.S * n, perm))
    want = dense[idx][:, idx].reshape(sp, n, sp, n).permute(0, 2, 1, 3)
    got = torch.cat(exe.group_blocks())
    assert got.shape == (sp, sp, n, n)
    assert torch.equal(got, want)


def test_comm_contract_on_a_one_rank_mesh(cora_half):
    """A 1 x 1 mesh issues no collective: CC004, vacuously."""
    prof = cora_half.profile
    exe = runtime.compile(ZooSpec("gcn", prof.feature_dim, 8,
                                  prof.num_classes), cora_half, device="cpu",
                          backend="reference", max_shard_n=128,
                          mesh=_mesh(1, 1))
    findings = check_sharded_executable(exe)
    assert [f.rule for f in findings] == ["CC004"]
    assert "mesh: LocalMesh data=1 model=1" in exe.summary()


@pytest.mark.parametrize("arch", ["sage_max", "gat"])
def test_unsupported_archs_raise(cora_half, arch):
    prof = cora_half.profile
    with pytest.raises(NotImplementedError, match="sharded execution"):
        runtime.compile(ZooSpec(arch, prof.feature_dim, 8, prof.num_classes),
                        cora_half, device="cpu", backend="reference",
                        max_shard_n=128, mesh=_mesh(2, 1))


def test_compile_argument_checks(cora_half):
    prof = cora_half.profile
    spec = ZooSpec("gcn", prof.feature_dim, 8, prof.num_classes)
    kw = dict(device="cpu", backend="reference", max_shard_n=128)
    with pytest.raises(ValueError, match="autotune"):
        runtime.compile(spec, cora_half, mesh=_mesh(2, 1), plan="autotune",
                        **kw)
    with pytest.raises(ValueError, match="partition must be"):
        runtime.compile(spec, cora_half, mesh=_mesh(2, 1),
                        partition="metis", **kw)
    # the plan memo is keyed on the partition method
    a = runtime.compile(spec, cora_half, mesh=_mesh(2, 1), **kw)
    b = runtime.compile(spec, cora_half, mesh=_mesh(2, 1),
                        partition="fennel", **kw)
    assert a.plan == b.plan
    s0 = runtime.plan_cache_stats()
    runtime.compile(spec, cora_half, mesh=_mesh(2, 1), partition="fennel",
                    hub_cache=37, **kw)
    assert runtime.plan_cache_stats()["misses"] == s0["misses"] + 1
