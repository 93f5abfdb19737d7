"""The production-mesh dry-run (``repro_torch.launch.dryrun``) on fake
process groups.

* ``run_cell`` returns ``ok`` for every arch at its smoke size on fake
  2 x 2 and 2 x 2 x 2 meshes, for every shape kind (at small shapes of
  the kinds of ``SHAPES``; on the 2 x 2 x 2 mesh the train kind for a
  dense and a MoE arch, and no mamba2 or musicgen cell: see
  ``NOT_3D``); each record carries the reference's fields.
* The per-device argument bytes of a train cell equal the bytes of the
  shards the reference's specs give its train state and inputs.
* The 2p/4p extrapolation of FLOPs, bytes and collectives equals a trace
  of the full depth for a smoke model deeper than 4p.
* One known redistribute logs one all-gather of the ring wire bytes.
* The fake process group and the mesh are made inside ``main`` (which
  runs one full-size cell), never when the module is imported; the
  abstract kernel backend is named nowhere else in the port.

JAX and the reference package are imported inside fixtures only.
"""
import ast
import dataclasses
import math
import pathlib
import subprocess
import sys
import types

import pytest
import torch

from repro_torch.configs import registry as t_configs
from repro_torch.dist.comm import CollectiveLogger, wire_bytes
from repro_torch.dist.shardings import ShardingRules
from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
# small shapes of each kind (the dry-run keys cells by these names)
SMALL = {name: dataclasses.replace(spec, seq_len=min(spec.seq_len, 64),
                                   global_batch=min(spec.global_batch, 8))
         for name, spec in t_configs.SHAPES.items()}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from jax.sharding import PartitionSpec

    from repro.configs import registry
    from repro.dist import compat, shardings
    from repro.launch import inputs
    from repro.training import train_loop
    return types.SimpleNamespace(jax=jax, P=PartitionSpec, registry=registry,
                                 compat=compat, shardings=shardings,
                                 inputs=inputs, train_loop=train_loop)


def _fake_mesh(shape, names):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dryrun._fake_group(math.prod(shape))
    try:
        return init_device_mesh("cpu", shape, mesh_dim_names=names)
    except Exception:
        dist.destroy_process_group()
        raise


@pytest.fixture(params=sorted(MESHES))
def mesh(request):
    import torch.distributed as dist

    m = _fake_mesh(*MESHES[request.param])
    try:
        yield m
    finally:
        dist.destroy_process_group()


@pytest.fixture
def small_shapes(monkeypatch):
    """Small shapes of each kind, and each arch's smoke config."""
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    monkeypatch.setattr(dryrun, "get_config", t_configs.get_smoke)


# On the 3-d mesh DTensor's first-call layout search is slow on a CPU
# (torch 2.13): ~15 s for a train trace, and minutes for the decode
# einsums of mamba2's SSD and the codebook heads of musicgen. There the dense and the MoE
# arch train, and every arch but those two runs the other kinds (all ten
# run every kind on the 2 x 2 mesh; their specs on both production
# meshes are tests/test_torch_shardings.py's).
TRAIN_3D = ("qwen2.5-3b", "qwen2-moe-a2.7b")
NOT_3D = ("mamba2-1.3b", "musicgen-large")


@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_run_cell_ok_for_every_arch(mesh, small_shapes, tmp_path, arch):
    for shape in SMALL:
        if mesh.ndim == 3 and (arch in NOT_3D or (
                shape == "train_4k" and arch not in TRAIN_3D)):
            continue
        rec = dryrun.run_cell(arch, shape, "single", mesh, tmp_path,
                              verbose=False)
        ok, _ = t_configs.shape_applicable(arch, shape)
        assert rec["status"] == ("ok" if ok else "skipped"), \
            rec.get("traceback")
        assert (tmp_path / f"{arch}__{shape}__single.json").exists()
        if not ok:
            continue
        assert rec["devices"] == math.prod(mesh.shape)
        mem = rec["proof"]["memory"]
        assert set(mem) >= {"argument_bytes", "output_bytes", "temp_bytes",
                            "alias_bytes", "peak_bytes"}
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        costs = rec["costs"]
        assert costs["flops_per_device"] > 0
        assert costs["bytes_accessed_per_device"] > 0
        assert set(costs["collectives"]) == {"operand_bytes", "wire_bytes",
                                             "counts", "total_wire_bytes"}
        assert "[ok]" in dryrun.summary(rec)


def _shard_bytes(spec, shape, dtype_bytes, sizes) -> int:
    split = 1
    for entry in spec:
        for axis in (() if entry is None else
                     (entry,) if isinstance(entry, str) else entry):
            split *= sizes[axis]
    return math.prod(shape) * dtype_bytes // split


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "musicgen-large",
                                  "qwen2-vl-2b"])
def test_argument_bytes_are_the_reference_shards(jx, small_shapes, tmp_path,
                                                 arch):
    import torch.distributed as dist

    mesh = _fake_mesh(*MESHES["2x2"])
    try:
        _argument_bytes(jx, mesh, tmp_path, arch)
    finally:
        dist.destroy_process_group()


def _argument_bytes(jx, mesh, tmp_path, arch):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    shape, names = tuple(mesh.shape), mesh.mesh_dim_names
    rules = jx.shardings.ShardingRules(jx.compat.abstract_mesh(shape, names))
    cfg = jx.registry.get_smoke(arch)
    params, opt = jx.train_loop.abstract_train_state(cfg)
    p_axes, o_axes = jx.train_loop.train_state_axes(cfg)
    batch, b_axes = jx.inputs.input_specs(cfg, SMALL["train_4k"])
    want = 0
    for tree, axes in ((params, p_axes), (opt, o_axes), (batch, b_axes)):
        specs = jx.jax.tree.leaves(rules.tree_specs(tree, axes),
                                   is_leaf=lambda x: isinstance(x, jx.P))
        for leaf, spec in zip(jx.jax.tree.leaves(tree), specs):
            want += _shard_bytes(tuple(spec), leaf.shape,
                                 leaf.dtype.itemsize, sizes)
    rec = dryrun.run_cell(arch, "train_4k", "single", mesh, tmp_path,
                          verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["proof"]["memory"]["argument_bytes"] == want


def test_extrapolation_equals_full_depth(small_shapes):
    """Every per-layer quantity is linear in depth: the 2p/4p line
    through a 2- and a 4-layer trace hits a 6-layer trace exactly."""
    import torch.distributed as dist

    m = _fake_mesh(*MESHES["2x2"])
    try:
        rules = ShardingRules(m)
        backend = dryrun._backend()
        cfg = dataclasses.replace(t_configs.get_smoke("qwen2.5-3b"),
                                  n_layers=6)
        assert dryrun._cost_depths(cfg) == (2, 4)
        for shape in ("train_4k", "prefill_32k"):
            r = {d: dryrun.trace_once(*dryrun._build_step(
                dryrun._reduced(cfg, d), SMALL[shape], rules, backend),
                rules, backend) for d in (2, 4, 6)}
            ext = dryrun._extrapolate(r[2], r[4], 2, 4, 6)
            for key in ("flops_per_device", "bytes_accessed_per_device"):
                assert ext[key] == r[6][key], (shape, key)
            coll = r[6]["collectives"]
            for kind in ("operand_bytes", "wire_bytes", "counts"):
                assert ext["collectives"][kind] == pytest.approx(
                    coll[kind], rel=1e-12), (shape, kind)
            assert r[6]["flops_per_device"] > r[4]["flops_per_device"]
    finally:
        dist.destroy_process_group()


def test_known_redistribute_logs_one_allgather():
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    m = _fake_mesh(*MESHES["2x2"])
    try:
        x = distribute_tensor(torch.empty(8, 16, device="meta"), m,
                              [Shard(0), Replicate()], src_data_rank=None)
        with CollectiveLogger(mesh=m) as logger:
            y = x.redistribute(m, [Replicate(), Replicate()])
        assert tuple(y.to_local().shape) == (8, 16)
        (e,) = logger.log.entries
        assert (e.kind, e.axis, e.nbytes, e.group) == \
            ("all-gather", "data", 8 * 16 * 4, 2)
        assert e.wire_bytes == wire_bytes("all-gather", 512, 2) == 512.0
        stats = logger.log.stats()
        assert stats.counts == {"all-gather": 1}
        assert stats.total_wire_bytes == 512.0
    finally:
        dist.destroy_process_group()


def test_peak_storages_and_aliases():
    """``DeviceCosts`` lists the storages live at its peak, largest
    first, with the op that made each; a collective's result that torch
    wraps for autograd (an alias on a card) counts once."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    m = _fake_mesh(*MESHES["2x2"])
    try:
        costs = dryrun.DeviceCosts(m)
        with costs:
            a = torch.ones(1000, device="meta") * 2.0   # peak: ones + a
            b = torch.ones(10, device="meta") + 1.0
        top = costs.peak_storages()
        assert [n for n, _ in top] == [4000, 4000]
        assert sorted(lab.split(" (")[0] for _, lab in top) == ["mul", "ones"]
        assert costs.peak == 8000 and costs.live == 4040
        del a, b
        assert costs.live == 0
        x = distribute_tensor(torch.empty(8, 16, device="meta"), m,
                              [Shard(0), Replicate()], src_data_rank=None)
        costs = dryrun.DeviceCosts(m)
        with costs:
            y = x.redistribute(m, [Replicate(), Replicate()])
        assert tuple(y.to_local().shape) == (8, 16)
        assert costs.peak == 8 * 16 * 4
    finally:
        dist.destroy_process_group()


def test_peak_check_runs_on_four_cpu_ranks(capsys):
    """``launch/peak_check.py`` traces the estimate and runs the sharded
    step in four gloo processes (no peak is measured on the CPU)."""
    import json

    from repro_torch.launch import peak_check

    assert peak_check.main(["--device", "cpu", "--smoke", "--mesh", "2x2",
                            "--batch", "4", "--seq", "16",
                            "--steps", "1"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (mesh,) = rec["meshes"]
    assert mesh["mesh"] == "2x2" and mesh["predicted_bytes"] > 0
    assert mesh["measured_bytes"] == [None] * 4
    assert len({tuple(x) for x in mesh["losses"]}) == 1


def test_nothing_happens_at_import():
    """Importing the module creates no process group: the group and the
    mesh are made inside ``main``; no module-level statement calls
    anything."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch.distributed as d, repro_torch.launch.dryrun;"
         "print(d.is_initialized())"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
    tree = ast.parse((ROOT / "src/repro_torch/launch/dryrun.py").read_text())
    for node in tree.body:
        assert isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef,
                                 ast.ClassDef, ast.Assign, ast.Expr,
                                 ast.If)), ast.dump(node)[:80]
        if isinstance(node, ast.Assign):
            assert not any(isinstance(n, ast.Call)
                           for n in ast.walk(node.value)), node.lineno
        if isinstance(node, ast.If):   # only the __main__ guard
            assert "__main__" in ast.unparse(node.test)


def test_abstract_backend_only_in_the_dryrun():
    for path in sorted((ROOT / "src/repro_torch").rglob("*.py")):
        if path.name == "dryrun.py":
            continue
        text = path.read_text()
        assert "AbstractBackend" not in text, path
        assert '"abstract"' not in text, path


def test_main_runs_a_production_cell(tmp_path):
    """``main`` makes the 256-rank fake group and the (16, 16) mesh,
    runs the cell at full size and tears the group down."""
    import json

    import torch.distributed as dist

    dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", str(tmp_path)])
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "qwen2.5-3b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256
    assert rec["costs"]["mode"] == rec["proof"]["mode"] == "exact"
