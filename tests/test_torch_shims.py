"""The reference's last public names in the port: the zoo's deprecation
shims (and the engine's ``submit`` / ``flush``), ``utils.pad_to`` /
``human_bytes``, the package exports, and the public-name comparison of
the two packages.

The shims warn ``DeprecationWarning`` as the reference's do and give
what the runtime gives; ``init_zoo`` draws from a ``torch.Generator``,
so only its tree's keys, shapes and dtypes can equal the reference's.
The comparison walks every module of ``src/repro``: each top-level
public name must have a same-named counterpart in the port's module of
the same path, or be named in that module's docstring (or its package's)
as needing none.
"""
import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.core.sharding import shard_graph as jax_shard_graph
from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo as jax_init_zoo
from repro.utils import human_bytes as jax_human_bytes
from repro.utils import pad_to as jax_pad_to
from repro_torch import configs, dist, gnn
from repro_torch.core.sharding import shard_graph
from repro_torch.gnn.models import (ARCHS, ZooSpec, build_zoo_graph,
                                    init_params, init_zoo, zoo_forward)
from repro_torch.graphs.datasets import make_dataset
from repro_torch.runtime.forward import build_graph_tensors, forward
from repro_torch.utils import human_bytes, pad_to

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
# reference modules whose counterpart has another name (or none: the
# dist package's docstring names compat.py's functions)
RENAMED = {"analyze/jaxpr_lint.py": "analyze/op_lint.py",
           "analyze/hlo_lint.py": "analyze/comm_lint.py",
           "dist/hlo_analysis.py": "dist/comm.py",
           "dist/compat.py": "dist/__init__.py"}


@pytest.fixture(scope="module")
def graph():
    return make_dataset("cora", seed=0, scale=0.1)


def test_build_zoo_graph_warns_and_builds(graph):
    prof = graph.profile
    with pytest.warns(DeprecationWarning, match="build_zoo_graph"):
        gt = build_zoo_graph(graph.edges, prof.num_nodes, 64, "gcn",
                             device="cpu")
    want = build_graph_tensors(graph.edges, prof.num_nodes, 64, "gcn", "cpu")
    assert (gt.S, gt.n, gt.num_nodes) == (want.S, want.n, want.num_nodes)
    assert torch.equal(gt.blocks, want.blocks)
    assert torch.equal(gt.edge_valid, want.edge_valid)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_zoo_tree_matches_reference(arch):
    jspec, spec = (JaxSpec(arch, 12, 8, 3, num_layers=3, heads=2),
                   ZooSpec(arch, 12, 8, 3, num_layers=3, heads=2))
    with pytest.warns(DeprecationWarning, match="init_zoo"):
        params = init_zoo(torch.Generator().manual_seed(0), spec, "cpu")
    jparams = jax_init_zoo(jax.random.key(0), jspec)
    assert len(params["layers"]) == len(jparams["layers"]) == 3
    for got, exp in zip(params["layers"], jparams["layers"]):
        assert sorted(got) == sorted(exp)
        for k in got:
            assert tuple(got[k].shape) == tuple(exp[k].shape), k
            assert str(got[k].dtype).split(".")[-1] == str(exp[k].dtype)
    # the same draw as init_params from the same generator state
    again = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    for got, exp in zip(params["layers"], again["layers"]):
        assert all(torch.equal(got[k], exp[k]) for k in got)


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_zoo_forward_warns_and_equals_runtime(graph, arch):
    prof = graph.profile
    spec = ZooSpec(arch, prof.feature_dim, 8, prof.num_classes)
    gt = build_graph_tensors(graph.edges, prof.num_nodes, 64, arch, "cpu")
    params = init_params(spec, torch.Generator().manual_seed(1), "cpu")
    h = gt.group(torch.from_numpy(graph.features))
    with pytest.warns(DeprecationWarning, match="zoo_forward"):
        out = zoo_forward(spec, params, gt, h)
    assert torch.equal(out, forward(spec, params, gt, h))


def test_engine_submit_flush_warn_and_serve(graph):
    from repro_torch.serving import GNNServeEngine, NodeRequest

    prof = graph.profile
    eng = GNNServeEngine(device="cpu", max_shard_n=64)
    eng.register_graph("cora", graph)
    eng.register_model("gcn", ZooSpec("gcn", prof.feature_dim, 8,
                                      prof.num_classes))
    reqs = [NodeRequest("cora", np.array([0, 5]), model="gcn"),
            NodeRequest("cora", np.array([7]), model="gcn")]
    with pytest.warns(DeprecationWarning, match="submit/flush"):
        for r in reqs:
            eng.submit(r)
    with pytest.warns(DeprecationWarning, match="submit/flush"):
        preds = eng.flush()
    want = eng.serve(reqs)
    assert [p.classes.tolist() for p in preds] == \
        [p.classes.tolist() for p in want]
    with pytest.warns(DeprecationWarning):
        assert eng.flush() == []            # the queue was drained


@pytest.mark.parametrize("shape,size,axis,value", [
    ((3, 4), 5, 0, 0.0), ((3, 4), 7, 1, -1.5), ((3, 4), 2, 0, 0.0),
    ((2, 3, 4), 6, 1, 2.0), ((2, 3, 4), 5, -1, 0.0), ((5,), 8, 0, 1.0)])
def test_pad_to_matches_reference(shape, size, axis, value):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    exp = np.asarray(jax_pad_to(x, size, axis, value))
    got = pad_to(x, size, axis, value)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, exp)
    got_t = pad_to(torch.from_numpy(x), size, axis, value)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_array_equal(
        got_t.numpy(), np.asarray(jax_pad_to(jnp.asarray(x), size, axis,
                                             value)))


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1536.5, 2 ** 20 * 3,
                               5 * 2 ** 40, 2 ** 60, -2048])
def test_human_bytes_matches_reference(n):
    assert human_bytes(n) == jax_human_bytes(n)


def test_sharded_graph_properties_match_reference(graph):
    prof = graph.profile
    sg = shard_graph(graph.edges, prof.num_nodes, 64)
    jsg = jax_shard_graph(graph.edges, prof.num_nodes, 64)
    assert sg.n_padded == jsg.n_padded
    assert sg.density == jsg.density
    assert graph.size_mb == graph.features.nbytes / 2 ** 20


def test_package_exports():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for arch in configs.ARCHS:
        for shape in configs.SHAPES:
            assert configs.shape_applicable(arch, shape) == \
                jconfigs.shape_applicable(arch, shape)
    from repro_torch.dist.shardings import ShardingRules
    assert dist.ShardingRules is ShardingRules
    assert {"build_zoo_graph", "init_zoo", "zoo_forward"} <= set(gnn.__all__)


def _public_names(path: pathlib.Path) -> set[str]:
    """Top-level functions, classes and assignments without a leading
    underscore, plus a package ``__init__``'s ``__all__``."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == "__all__":
                    names |= set(ast.literal_eval(node.value))
                elif isinstance(target, ast.Name):
                    names.add(target.id)
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _docstrings(path: pathlib.Path) -> str:
    """The module's docstring and its package's."""
    texts = [ast.get_docstring(ast.parse(path.read_text())) or ""]
    init = path.parent / "__init__.py"
    if init != path and init.exists():
        texts.append(ast.get_docstring(ast.parse(init.read_text())) or "")
    return "\n".join(texts)


def test_every_reference_name_has_a_counterpart():
    missing = {}
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF).as_posix()
        port = PORT / RENAMED.get(rel, rel)
        assert port.exists(), f"{rel} has no counterpart module"
        if rel in RENAMED:      # another module: its names are its own
            names = _public_names(path) if rel == "dist/compat.py" else ()
        else:
            names = _public_names(path) - _public_names(port)
        docs = _docstrings(port)
        undocumented = sorted(n for n in names if f"``{n}``" not in docs)
        if undocumented:
            missing[rel] = undocumented
    assert not missing, missing
