"""Sharded serving and streaming on a ``LocalMesh``, and the three
launchers' ``--mesh`` on the CPU.

``GNNServeEngine(mesh=...)`` behind a ``Server`` answers as a
single-device engine does; a mesh rejects the archs it cannot run at
admission; a fennel-partitioned mutable engine takes streaming deltas in
template (the port of the reference's
``test_fennel_streaming_mutate_stays_in_template``) and a contiguous one
stays bitwise equal to a fresh sharded compile.
"""
import numpy as np
import pytest
import torch

from repro_torch import runtime
from repro_torch.gnn.models import ZooSpec
from repro_torch.graphs.datasets import make_dataset
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.serving import Completed, Rejected, SchedulerConfig, Server
from repro_torch.serving.gnn_engine import GNNServeEngine, NodeRequest
from repro_torch.stream import random_delta


def _mesh(n_data=4, n_model=2):
    return make_mesh_for(n_data * n_model, model_parallel=n_model,
                         device="cpu")


def _spec(arch, prof, hidden=8):
    return ZooSpec(arch, prof.feature_dim, hidden, prof.num_classes)


def test_engine_serves_sharded_like_a_single_device_engine():
    ds = make_dataset("cora", seed=0, scale=0.5)
    prof = ds.profile
    engines = {}
    for name, mesh in (("mesh", _mesh()), ("single", None)):
        eng = GNNServeEngine(device="cpu", max_shard_n=128,
                             backend="reference", mesh=mesh,
                             partition="fennel", hub_cache=64)
        eng.register_graph("cora", ds)
        for arch in ("gcn", "sage_mean", "gin", "gat", "sage_max"):
            eng.register_model(arch, _spec(arch, prof), seed=3)
        engines[name] = eng
    server = Server(engines["mesh"], SchedulerConfig(max_batch_size=4))
    rng = np.random.default_rng(0)
    reqs = [NodeRequest("cora", rng.integers(0, prof.num_nodes, 4), arch)
            for _ in range(4) for arch in ("gcn", "sage_mean", "gin")]
    tickets = [server.submit(r) for r in reqs]
    # admission rejects what a mesh cannot run, typed, before any step
    rejected = [server.submit(NodeRequest("cora", np.arange(3), arch))
                for arch in ("gat", "sage_max")]
    server.drain()
    for t in rejected:
        out = t.result()
        assert isinstance(out, Rejected) and "cannot run on a mesh" in \
            out.reason
    want = engines["single"].serve(reqs)
    for t, w in zip(tickets, want):
        out = t.result()
        assert isinstance(out, Completed)
        np.testing.assert_array_equal(out.value.classes, w.classes)
        np.testing.assert_allclose(out.value.probs, w.probs, atol=1e-5)
    exe = engines["mesh"].executable("gin", "cora")
    assert exe.mesh.shape == {"data": 4, "model": 2}
    assert engines["mesh"].device.type == "cpu"


def test_engine_argument_checks():
    with pytest.raises(ValueError, match="autotune"):
        GNNServeEngine(device="cpu", mesh=_mesh(), plan="autotune")
    with pytest.raises(ValueError, match="partition must be"):
        GNNServeEngine(device="cpu", mesh=_mesh(), partition="metis")


def _stream_engine(ds, partition):
    eng = GNNServeEngine(device="cpu", max_shard_n=128, backend="reference",
                         mesh=_mesh(), partition=partition, hub_cache=128,
                         streaming=True)
    eng.register_graph("g", ds)
    eng.register_model("gcn", _spec("gcn", ds.profile))
    return eng


def test_fennel_streaming_mutate_stays_in_template():
    """Edge churn through the engine on a fennel-partitioned mesh: the
    warm-started re-partition stays within the compiled hub/halo
    capacities (no recompile), keeps single-device parity, and keeps the
    comm contract verified after the burst."""
    ds = make_dataset("cora", seed=0, scale=0.5)
    eng = _stream_engine(ds, "fennel")
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    srv.submit(NodeRequest("g", np.arange(8), model="gcn"))
    srv.drain()
    sexe = eng.executable("gcn", "g")
    caps = (sexe.partition.hub_cap, sexe.partition.halo_cap)
    compiles0 = eng.stats["compiles"]
    rng = np.random.default_rng(0)
    for _ in range(4):
        rep = srv.mutate("g", random_delta(ds, rng, edge_ops=4, p_node=0.5))
        assert all(not m.get("recompile") for m in rep["executables"])
    assert eng.stats["compiles"] == compiles0
    assert eng.executable("gcn", "g") is sexe
    assert (sexe.partition.hub_cap, sexe.partition.halo_cap) == caps
    exe = runtime.compile(_spec("gcn", ds.profile), ds, device="cpu",
                          backend="reference", max_shard_n=128,
                          params=eng.model_params("gcn"))
    np.testing.assert_allclose(sexe.forward().numpy(),
                               exe.forward().numpy(), atol=1e-4, rtol=1e-4)
    sexe.verify_comm(rtol=0.0)


def test_fennel_capacity_overflow_recompiles():
    """A delta past the pinned capacities raises inside update_graph
    before anything is adopted; the engine drops the unit and the next
    request recompiles it on the post-delta graph."""
    ds = make_dataset("cora", seed=0, scale=0.5)
    eng = _stream_engine(ds, "fennel")
    sexe = eng.executable("gcn", "g")
    plan = sexe.partition
    sexe.partition = type(plan)(**{**plan.__dict__, "halo_cap": 1})
    rep = eng.mutate("g", random_delta(ds, np.random.default_rng(1),
                                       edge_ops=4))
    assert rep["executables"] == [{"model": "gcn", "recompile": True}]
    assert eng.stats["graph_recompiles"] == 1
    fresh = eng.executable("gcn", "g")
    assert fresh is not sexe and fresh.partition.halo_cap > 1


def test_contiguous_streaming_equals_a_fresh_sharded_compile():
    ds = make_dataset("cora", seed=0, scale=0.5)
    eng = _stream_engine(ds, "contiguous")
    sexe = eng.executable("gcn", "g")
    sexe.forward()
    old_indexes = sexe.group_indexes()
    rng = np.random.default_rng(2)
    for _ in range(3):
        rep = eng.mutate("g", random_delta(ds, rng, edge_ops=6, p_node=0.5))
        assert not any(m.get("recompile") for m in rep["executables"])
    assert sexe.group_indexes() is not old_indexes   # rebuilt, copy-on-write
    fresh = runtime.compile(_spec("gcn", ds.profile), ds, device="cpu",
                            backend="reference", max_shard_n=128,
                            params=eng.model_params("gcn"), mesh=_mesh())
    assert torch.equal(sexe.forward(), fresh.forward())


def test_serve_launcher_with_a_mesh(capsys):
    from repro_torch.launch import serve

    serve.main(["--mode", "gnn", "--device", "cpu", "--graphs", "cora",
                "--scale", "0.1", "--shard-n", "64", "--num-requests", "6",
                "--models", "gcn,gin", "--mesh", "4", "--model-parallel",
                "2", "--partition", "fennel", "--hub-cache", "16",
                "--backend", "reference"])
    out = capsys.readouterr().out
    assert "data=2 x model=2" in out and "served 6/6 requests" in out
    with pytest.raises(SystemExit, match="supports"):
        serve.main(["--mode", "gnn", "--device", "cpu", "--graphs", "cora",
                    "--scale", "0.1", "--models", "gat", "--mesh", "2"])


def test_train_launcher_with_a_mesh(capsys):
    from repro_torch.launch import train_gnn

    train_gnn.main(["--device", "cpu", "--dataset", "cora", "--arch", "gin",
                    "--steps", "2", "--scale", "0.1", "--shard-n", "64",
                    "--mesh", "4", "--model-parallel", "2", "--backend",
                    "reference", "--verify-comm"])
    out = capsys.readouterr().out
    assert "mesh: data=2 x model=2" in out
    assert "(counted all-gather >= model: verified)" in out


def test_stream_launcher_with_a_mesh(capsys):
    from repro_torch.launch import stream

    out = stream.run(stream.parser().parse_args(
        ["--device", "cpu", "--scale", "0.1", "--shard-n", "64",
         "--mutations", "4", "--finetune-every", "2", "--steps", "2",
         "--requests-per-mutation", "2", "--mesh", "4",
         "--model-parallel", "2"]))
    assert out["ok"] and out["served"] == out["submitted"] == 8
    assert out["engine_stats"]["graph_recompiles"] == 0
    assert "[stream] OK" in capsys.readouterr().out
