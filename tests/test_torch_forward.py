"""Forward parity: the port's forward against ``repro.runtime.forward``.

Both sides get the same numpy graph, features and parameters (the
reference package's ``init_zoo`` draw) and run under the same ModelPlan;
the reference side runs its ``reference`` backend, the port its default
``cuda`` backend, which takes the plain versions for CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.gnn.executor import plan_model as jax_plan_model
from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo
from repro.kernels.registry import get_backend
from repro.runtime.forward import build_graph_tensors as jax_build
from repro.runtime.forward import forward as jax_forward
from repro_torch.gnn.executor import LayerPlan
from repro_torch.gnn.models import ZooSpec, params_from_numpy
from repro_torch.graphs.datasets import make_dataset
from repro_torch.kernels.registry import resolve
from repro_torch.runtime.forward import build_graph_tensors, forward

TOL = dict(atol=1e-4, rtol=1e-4)
SHARD_N = 64          # cora at scale 0.1 (270 nodes) -> a 5x5 shard grid


@pytest.fixture(scope="module")
def graph():
    return make_dataset("cora", seed=0, scale=0.1)


def _run_both(graph, arch, *, fused=None, hidden=16, layers=2):
    prof = graph.profile
    dims = (prof.feature_dim, hidden, prof.num_classes)
    jspec, tspec = JaxSpec(arch, *dims, num_layers=layers), \
        ZooSpec(arch, *dims, num_layers=layers)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     init_zoo(jax.random.key(3), jspec))
    plan = jax_plan_model(jspec, prof.num_nodes, graph.edges.shape[0],
                          max_n=SHARD_N)
    jlayers = plan.layers
    if fused is not None:
        jlayers = tuple(dataclasses.replace(p, fused=fused) for p in jlayers)
    tlayers = tuple(LayerPlan.from_json(p.to_json()) for p in jlayers)

    jgt = jax_build(graph.edges, prof.num_nodes, SHARD_N, arch)
    tgt = build_graph_tensors(graph.edges, prof.num_nodes, SHARD_N, arch,
                              "cpu")
    exp = jax_forward(jspec, jparams, jgt,
                      jgt.group(jnp.asarray(graph.features)),
                      plans=jlayers, backend=get_backend("reference"))
    out = forward(tspec, params_from_numpy(jparams, "cpu"), tgt,
                  tgt.group(torch.from_numpy(graph.features)),
                  plans=tlayers, backend=resolve("cuda"))
    return out, np.asarray(exp), tlayers


@pytest.mark.parametrize("arch,fused", [
    ("gcn", True), ("gcn", False), ("sage_mean", None), ("sage_max", None)])
def test_forward_matches_reference(graph, arch, fused):
    out, exp, layers = _run_both(graph, arch, fused=fused)
    assert out.shape == exp.shape == (graph.profile.num_nodes,
                                      graph.profile.num_classes)
    if fused is None:
        # the planner's own choice: gcn fuses, the sage archs never do
        assert not any(p.fused for p in layers)
    np.testing.assert_allclose(out.numpy(), exp, **TOL)


def test_gcn_planner_fuses(graph):
    prof = graph.profile
    plan = jax_plan_model(JaxSpec("gcn", prof.feature_dim, 16,
                                  prof.num_classes),
                          prof.num_nodes, graph.edges.shape[0], max_n=SHARD_N)
    assert all(p.fused for p in plan.layers)


def test_deeper_model_matches_reference(graph):
    out, exp, _ = _run_both(graph, "sage_max", hidden=8, layers=3)
    np.testing.assert_allclose(out.numpy(), exp, **TOL)


@pytest.mark.parametrize("arch", ["gin", "gat"])
def test_unported_archs_raise(graph, arch):
    """gin and gat were the unported archs; both run now (their forwards
    are held to the reference here and in tests/test_torch_gin_gat.py),
    and so does training them with an autotuned plan. On a mesh, as in
    the reference, gin trains and gat raises NotImplementedError: the
    sharded program supports the linear-aggregation archs only."""
    from repro_torch import runtime
    from repro_torch.launch.mesh import make_mesh_for

    out, exp, _ = _run_both(graph, arch)
    np.testing.assert_allclose(out.numpy(), exp, **TOL)
    prof = graph.profile
    spec = ZooSpec(arch, prof.feature_dim, 16, prof.num_classes)
    mesh = make_mesh_for(2, model_parallel=1, device="cpu")
    if arch == "gat":
        with pytest.raises(NotImplementedError, match="sharded execution"):
            runtime.fit(spec, graph, steps=1, device="cpu", mesh=mesh,
                        log=lambda s: None)
    else:
        res = runtime.fit(spec, graph, steps=1, device="cpu", mesh=mesh,
                          log=lambda s: None)
        assert res.executable.mesh is mesh and len(res.history) == 1
    res = runtime.fit(spec, graph, steps=1, device="cpu", plan="autotune",
                      tune_budget=2, log=lambda s: None)
    assert res.executable.plan_source == "autotune"
