"""The meshes and their comm log: ``dist/mesh.py``, ``dist/comm.py``,
``launch/mesh.py`` and the comm contract's rules (``analyze/comm_lint.py``).

The ``ProcessGroupMesh`` test spawns four gloo processes (a 2 x 2 mesh,
then a 1 x 4 one) on the CPU, each running ``tests/torch_dist_worker.py``;
rank 0's logits, one train step's gradients and its comm log must equal
the ``LocalMesh`` run of the same program in this process.
"""
import multiprocessing
import queue as queue_mod

import numpy as np
import pytest
import torch

import torch_dist_worker
from repro_torch.analyze.comm_lint import (check_comm_contract,
                                           check_partition_quality)
from repro_torch.dist.comm import (CollectiveStats, CommLog, CommRecorder,
                                   wire_bytes)
from repro_torch.dist.mesh import LocalMesh, ProcessGroupMesh
from repro_torch.launch.mesh import make_mesh_for, mesh_from_cli


def test_wire_bytes_follow_the_ring_convention():
    assert wire_bytes("all-gather", 100, 4) == 300.0
    assert wire_bytes("all-reduce", 100, 4) == 150.0
    assert wire_bytes("reduce-scatter", 100, 4) == 75.0
    assert wire_bytes("all-to-all", 100, 4) == 75.0
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all"):
        assert wire_bytes(kind, 100, 1) == 0.0
    with pytest.raises(ValueError, match="unknown collective"):
        wire_bytes("collective-permute", 100, 4)


def test_comm_log_counts_instructions():
    log = CommLog()
    log.record("all-gather", "data", 1000, 4)
    log.record("all-reduce", "model", 64, 2)
    log.record("all-reduce", "model", 64, 1)        # a size-1 axis: nothing
    log.record("reduce-scatter", "data", 250, 4, backward=True)
    st = log.stats()
    assert st.counts == {"all-gather": 1, "all-reduce": 1,
                         "reduce-scatter": 1}
    assert st.wire_bytes == {"all-gather": 3000.0, "all-reduce": 64.0,
                             "reduce-scatter": 187.5}
    assert st.total_wire_bytes == 3251.5
    assert log.allgather_ops() == [3000.0]
    rec = CommRecorder()
    rec.record("all-gather", "data", 10, 2)         # outside a capture
    with rec.capture() as outer:
        with rec.capture() as inner:
            rec.record("all-gather", "data", 10, 2)
        rec.record("all-reduce", "model", 10, 2)
    assert [e.kind for e in inner.entries] == ["all-gather"]
    assert [e.kind for e in outer.entries] == ["all-reduce"]


def test_local_mesh_collectives_and_their_transposes():
    mesh = LocalMesh(2, 2, "cpu")
    assert mesh.shape == {"data": 2, "model": 2} and mesh.size == 4
    assert mesh.local_ranks == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.axis_index("data") == [0, 0, 1, 1]
    assert mesh.axis_index("model") == [0, 1, 0, 1]
    xs = [torch.full((3, 2), float(r), requires_grad=True) for r in range(4)]
    with mesh.comm.capture() as log:
        gathered = mesh.all_gather(xs, "data")
        summed = mesh.psum(xs, "model")
        # one tensor per group, shared by the group's ranks
        assert gathered[0] is gathered[2] and gathered[1] is gathered[3]
        assert summed[0] is summed[1] and summed[2] is summed[3]
        torch.testing.assert_close(gathered[1],
                                   torch.cat([xs[1], xs[3]]))
        torch.testing.assert_close(summed[2], xs[2] + xs[3])
        loss = sum(g.sum() for g in gathered) + sum(s.sum() for s in summed)
        grads = torch.autograd.grad(loss, xs)
    # each rank's block reaches the loss through its data group's gather
    # (counted once per group member that uses it) and its model group's
    # psum (twice: both model peers hold the sum)
    for g in grads:
        torch.testing.assert_close(g, torch.full((3, 2), 4.0))
    assert [(e.kind, e.axis, e.nbytes, e.group, e.backward)
            for e in log.entries] == [
        ("all-gather", "data", 48, 2, False),
        ("all-reduce", "model", 24, 2, False),
        ("all-reduce", "model", 24, 2, True),
        ("reduce-scatter", "data", 24, 2, True)]
    assemble = mesh.assemble(summed)
    torch.testing.assert_close(assemble, torch.cat([summed[0], summed[2]]))
    with pytest.raises(ValueError, match="axis"):
        mesh.psum(xs, "pod")
    with pytest.raises(ValueError, match="holds 4 values"):
        mesh.psum(xs[:3], "model")


def test_make_mesh_for_and_mesh_from_cli(monkeypatch):
    mesh = make_mesh_for(8, model_parallel=2, device="cpu")
    assert isinstance(mesh, LocalMesh)
    assert (mesh.n_data, mesh.n_model, mesh.device.type) == (4, 2, "cpu")
    with pytest.raises(AssertionError):
        make_mesh_for(6, model_parallel=4, device="cpu")
    with pytest.raises(SystemExit, match="multiple"):
        mesh_from_cli(6, 4, "cpu")
    assert mesh_from_cli(4, 1, "cpu").shape == {"data": 4, "model": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh_for(8, model_parallel=2)


def test_process_group_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        ProcessGroupMesh(2, 2)


def test_comm_contract_rules():
    ok = CollectiveStats({}, {"all-gather": 300.0, "all-reduce": 64.0},
                         {"all-gather": 1, "all-reduce": 1})
    assert check_comm_contract(ok, expected_allgather_bytes=300.0,
                               plan_allgather_bytes=300.0) == []
    off = check_comm_contract(ok, expected_allgather_bytes=200.0,
                              plan_allgather_bytes=300.0, rtol=0.0)
    assert [f.rule for f in off] == ["CC001", "CC002"]
    extra = CollectiveStats({}, {"all-gather": 300.0, "reduce-scatter": 9.0},
                            {"all-gather": 1, "reduce-scatter": 1})
    assert [(f.rule, f.severity) for f in check_comm_contract(
        extra, expected_allgather_bytes=300.0)] == [("CC003", "warning")]
    none = CollectiveStats({}, {}, {})
    assert [f.rule for f in check_comm_contract(
        none, expected_allgather_bytes=0.0)] == ["CC004"]

    class Plan:
        def __init__(self, frac, method="fennel"):
            self.cross_group_edge_frac, self.method = frac, method
            self.hub_rows = 0

    assert check_partition_quality(Plan(0.1), Plan(0.5))[0].severity == \
        "info"
    bad = check_partition_quality(Plan(0.6), Plan(0.5))
    assert (bad[0].rule, bad[0].severity) == ("CC005", "error")


def spawn_process_group_mesh(tmp_path, backend: str) -> dict:
    """Run ``torch_dist_worker.worker`` in four spawned processes and
    return rank 0's results. Every wait has a timeout and the children
    are killed after it, so a hang fails the caller."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=torch_dist_worker.worker,
                         args=(rank, 4, store, results, backend),
                         daemon=True)
             for rank in range(4)]
    for p in procs:
        p.start()
    try:
        got = results.get(timeout=240)     # drained before the joins
    except queue_mod.Empty:
        got = None
    finally:
        for p in procs:
            p.join(timeout=60)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(timeout=10)
    assert got is not None, "rank 0 returned nothing"
    assert not alive and all(p.exitcode == 0 for p in procs), \
        [p.exitcode for p in procs]
    return got


def assert_same_runs(got: dict, device: str, backend: str) -> None:
    """Each case of a ProcessGroupMesh run equals a LocalMesh's run of it
    on ``device``: logits, gradients and the comm log."""
    for shape, cases in torch_dist_worker.CASES.items():
        mesh = LocalMesh(*shape, device)
        for case in cases:
            want = torch_dist_worker.run_case(mesh, *case, backend=backend)
            have = got[shape, case]
            if shape[1] <= 2:
                np.testing.assert_array_equal(have["logits"],
                                              want["logits"])
            else:   # a psum of more than two terms: the ring adds them
                    # in another order than LocalMesh's left fold
                np.testing.assert_allclose(have["logits"], want["logits"],
                                           rtol=1e-5, atol=1e-7)
            assert have["grads"].keys() == want["grads"].keys()
            for k, g in want["grads"].items():
                np.testing.assert_allclose(have["grads"][k], g, rtol=1e-5,
                                           atol=1e-7)
            assert have["comm"] == want["comm"]
            kinds = {e[0] for e in want["comm"]}
            assert kinds == ({"all-gather", "all-reduce", "reduce-scatter"}
                             if shape[0] > 1 else {"all-reduce"})


def test_process_group_mesh_matches_local_mesh(tmp_path):
    """Four gloo processes (data 2 x model 2, then data 1 x model 4; a
    FileStore in tmp_path): rank 0's logits, step gradients and comm log
    equal the LocalMesh's."""
    got = spawn_process_group_mesh(tmp_path, "gloo")
    assert_same_runs(got, "cpu", "reference")


def test_process_group_mesh_defaults_to_a_card(tmp_path, monkeypatch):
    """With no ``device``, a ProcessGroupMesh runs on a card whatever the
    backend, and raises without one (a gloo group does not mean the
    CPU)."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            ProcessGroupMesh(1, 1)
        assert ProcessGroupMesh(1, 1, device="cpu").device.type == "cpu"
    finally:
        dist.destroy_process_group()
