"""The port's sharding rules (``repro_torch.dist.shardings``) against the
reference's ``repro.dist.shardings``.

For each of the ten archs on both production meshes — (16, 16) ``("data",
"model")`` and (2, 16, 16) ``("pod", "data", "model")`` — the port's spec
of every leaf equals ``tuple(PartitionSpec)`` of the reference: the
parameters, the scanned (stacked) parameters, the decode caches at
decode_32k and long_500k, the train state and the inputs of every shape.
Both sides plan on device-free meshes (the reference's
``compat.abstract_mesh``, the port's ``{axis: size}`` mapping). The six
``tests/test_dist.py::TestShardingRules`` cases run as one parametrised
test, and the DTensor placements of a spec are checked on a fake
process group's ``DeviceMesh``.

JAX and the reference package are imported inside fixtures only.
"""
import types

import pytest
import torch

from repro_torch.configs import registry as t_configs
from repro_torch.dist.shardings import DEFAULT_RULES, ShardingRules
from repro_torch.launch import inputs as t_inputs
from repro_torch.models import lm as t_lm
from repro_torch.nn.layers import Axes
from repro_torch.training import train_loop as t_train

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    from jax.sharding import PartitionSpec

    from repro.configs import registry
    from repro.dist import compat, shardings
    from repro.launch import inputs
    from repro.models import lm
    from repro.nn.layers import Axes as JAxes
    from repro.training import train_loop
    return types.SimpleNamespace(jax=jax, P=PartitionSpec, registry=registry,
                                 compat=compat, shardings=shardings,
                                 inputs=inputs, lm=lm, Axes=JAxes,
                                 train_loop=train_loop)


def _key(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def ref_specs(jx, rules, tree, axes) -> dict:
    """path -> tuple(spec) of the reference's specs of ``tree``."""
    specs = rules.tree_specs(tree, axes)
    flat, _ = jx.jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jx.P))
    return {"/".join(_key(k) for k in path): tuple(spec)
            for path, spec in flat}


def port_paths(tree, prefix: str = "", like=None) -> dict:
    """path -> leaf of a port tree (dicts, lists, tuples); with ``like``
    (a tree of that structure), the subtrees at its leaves' paths."""
    like = tree if like is None else like
    if isinstance(like, dict):
        out = {}
        for k, v in like.items():
            out.update(port_paths(tree[k], f"{prefix}{k}/", v))
        return out
    if isinstance(like, (list, tuple)):
        out = {}
        for i, v in enumerate(like):
            out.update(port_paths(tree[i], f"{prefix}{i}/", v))
        return out
    return {prefix[:-1]: tree}


def _trees(side, cfg, shapes, cache_shapes):
    """(name, tree, axes) of every tree the specs are compared on, built
    by one package's modules (``side``: lm, train_loop, inputs)."""
    out = [("params", side.lm.abstract_params(cfg), side.lm.param_axes(cfg)),
           ("scanned", *side.lm.scanned_abstract_params(cfg))]
    params, opt = side.train_loop.abstract_train_state(cfg)
    p_axes, o_axes = side.train_loop.train_state_axes(cfg)
    out.append(("train_state", (params, opt), (p_axes, o_axes)))
    for name, shape in cache_shapes:
        out.append((f"cache_{name}",
                    side.lm.cache_struct(cfg, shape.global_batch,
                                         shape.seq_len, abstract=True),
                    side.lm.cache_axes(cfg)))
    for name, shape in shapes:
        out.append((f"inputs_{name}", *side.inputs.input_specs(cfg, shape)))
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", t_configs.ARCHS)
def test_specs_match_reference(jx, arch, mesh):
    shape, names = MESHES[mesh]
    jrules = jx.shardings.ShardingRules(jx.compat.abstract_mesh(shape, names))
    trules = ShardingRules(dict(zip(names, shape)))
    jcfg, tcfg = jx.registry.get_config(arch), t_configs.get_config(arch)
    jshapes = [(n, jx.registry.SHAPES[n]) for n in jx.registry.SHAPES]
    tshapes = [(n, t_configs.SHAPES[n]) for n in t_configs.SHAPES]
    caches = ("decode_32k", "long_500k")
    jside = types.SimpleNamespace(lm=jx.lm, train_loop=jx.train_loop,
                                  inputs=jx.inputs)
    tside = types.SimpleNamespace(lm=t_lm, train_loop=t_train,
                                  inputs=t_inputs)
    jtrees = _trees(jside, jcfg, jshapes,
                    [(n, s) for n, s in jshapes if n in caches])
    ttrees = _trees(tside, tcfg, tshapes,
                    [(n, s) for n, s in tshapes if n in caches])
    assert [t[0] for t in jtrees] == [t[0] for t in ttrees]
    n_leaves = 0
    for (name, jtree, jaxes), (_, ttree, taxes) in zip(jtrees, ttrees):
        want = ref_specs(jx, jrules, jtree, jaxes)
        leaves, axes = port_paths(ttree), port_paths(taxes)
        assert set(leaves) == set(want) == set(axes), name
        for path, spec in want.items():
            got = trules.spec(leaves[path].shape, axes[path])
            assert got == spec, (name, path, got, spec)
        got_tree = port_paths(trules.tree_specs(ttree, taxes), like=ttree)
        assert got_tree == want, name
        n_leaves += len(want)
    assert n_leaves > 0


RULE_CASES = {
    # tests/test_dist.py::TestShardingRules, with PartitionSpecs as tuples
    "basic_spec": (MESHES["single"], {}, [
        ((256, 4096), ("act_batch", "act_embed"), ("data", None)),
        ((4096, 12288), ("embed", "mlp"), ("data", "model"))]),
    "divisibility_guard": (MESHES["single"], {}, [
        ((40,), ("kv_heads_n",), (None,)),
        ((5120,), ("heads",), ("model",)),
        ((122753, 2304), ("vocab", "embed"), (None, "data"))]),
    "axis_reuse_guard": (MESHES["single"], {}, [
        ((2560, 2560), ("lru", "lru"), ("model", None))]),
    "multipod_combined_axis": (MESHES["multi"], {}, [
        ((256, 4096), ("act_batch", "act_seq"), (("pod", "data"), "model")),
        ((1, 4096), ("act_batch", "act_seq"), (None, "model"))]),
    "missing_mesh_axis_skipped": (MESHES["single"], {}, [
        ((256,), ("act_batch",), ("data",))]),
    "override": (MESHES["single"], {"act_seq": ()}, [
        ((64, 4096), ("act_batch", "act_seq"), ("data", None))]),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_sharding_rules_cases(case):
    (shape, names), overrides, checks = RULE_CASES[case]
    rules = ShardingRules(dict(zip(names, shape)))
    if overrides:
        rules = rules.override(**overrides)
    for dims, axes, want in checks:
        assert rules.spec(dims, Axes(axes)) == want, (dims, axes)


def test_default_rules_equal_reference(jx):
    assert DEFAULT_RULES == jx.shardings.DEFAULT_RULES
    with pytest.raises(ValueError, match="rank mismatch"):
        ShardingRules({"data": 2}).spec((4, 4), ("act_batch",))


@pytest.fixture
def fake_world():
    """A fake process group of 8 ranks (this process is rank 0), torn
    down after the test."""
    import torch.distributed as dist
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_placements_and_distribute(fake_world):
    """A spec becomes one placement per mesh dimension: a combined
    ``("pod", "data")`` entry shards tensor dim 0 on both; ``distribute``
    keeps rank 0's shards and ``constrain`` relays a DTensor out."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    rules = ShardingRules(mesh)
    spec = rules.spec((8, 5), ("act_batch", "act_seq"))
    assert spec == (("pod", "data"), None)
    assert rules.sharding((8, 5), ("act_batch", "act_seq")) == \
        (Shard(0), Shard(0), Replicate())
    assert rules.sharding((8, 4), ("act_batch", "act_seq")) == \
        (Shard(0), Shard(0), Shard(1))
    x = torch.arange(32.0).reshape(8, 4)
    d = rules.distribute({"x": x}, {"x": Axes(("act_batch", "act_seq"))})["x"]
    assert isinstance(d, DTensor)
    # rank 0 of every axis: rows 0-1 of 8 (pod then data), columns 0-1
    assert torch.equal(d.to_local(), x[:2, :2])
    # a split leaf's shard owns its storage (the full tensor can go)
    assert d.to_local().untyped_storage().nbytes() == 4 * 4
    assert rules.constrain(x, ("act_batch",)) is x
    c = rules.constrain(d, ("act_batch", "act_embed"))
    assert tuple(c.placements) == (Shard(0), Shard(0), Replicate())
    assert rules.constrain(c, ("act_batch", "act_embed")) is c
    with pytest.raises(TypeError, match="DeviceMesh"):
        ShardingRules({"data": 2}).sharding((4,), ("act_batch",))


def test_model_modules_hold_no_dtensor_code():
    """The model's modules (``nn/``, ``models/``) import nothing of
    ``torch.distributed``: their DTensor versions live in
    ``dist/sharded_ops.py``, registered for every ``@shardable``
    function, each once."""
    import pathlib
    import re

    from repro_torch.dist import sharded_ops  # noqa: F401
    from repro_torch.nn.layers import SHARDED

    root = pathlib.Path(t_lm.__file__).resolve().parents[1]
    marked = 0
    for sub in ("nn", "models"):
        for path in sorted((root / sub).glob("*.py")):
            text = path.read_text()
            assert "torch.distributed" not in text, path
            assert not re.search(r"isinstance\([^)]*DTensor", text), path
            marked += text.count("@shardable")
    assert marked == len(SHARDED) == 9
