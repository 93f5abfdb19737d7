"""gin and gat in the port against the reference package.

Both sides get the same numpy graph, features and parameters (the
reference's ``init_zoo`` draw, carried across by ``params_from_numpy``)
and run under the same ModelPlan; the reference runs its ``reference``
backend, the port its default ``cuda`` backend, which takes the plain
versions for CPU tensors. Tolerance: atol = rtol = 1e-4 (float32; the
two sides add in different orders).

gat's attention weights are computed per nonzero of the graph's kept
linear index; they are held to the reference's dense (S, S, n, n) α grid
(``_gat_attention_blocks``, and a torch copy of it) at the index's
entries.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import runtime as jax_runtime
from repro.gnn.executor import plan_model as jax_plan_model
from repro.gnn.models import ZooSpec as JaxSpec
from repro.gnn.models import init_zoo
from repro.kernels.registry import get_backend
from repro.runtime.forward import _gat_attention_blocks
from repro.runtime.forward import build_graph_tensors as jax_build
from repro.runtime.forward import forward as jax_forward
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import Server as JaxServer
from repro.serving.gnn_engine import GNNServeEngine as JaxEngine
from repro.serving.gnn_engine import NodeRequest as JaxRequest
from repro_torch import runtime
from repro_torch.gnn.executor import LayerPlan
from repro_torch.gnn.models import ZooSpec, init_params, params_from_numpy
from repro_torch.graphs.datasets import make_dataset
from repro_torch.kernels import csr, ref
from repro_torch.kernels.registry import resolve
from repro_torch.runtime.forward import (build_graph_tensors, forward,
                                         gat_attention)
from repro_torch.serving import (Completed, GNNServeEngine, NodeRequest,
                                 SchedulerConfig, Server)

TOL = dict(atol=1e-4, rtol=1e-4)
SHARD_N = 64          # cora at scale 0.1 (270 nodes) -> a 5x5 shard grid


@pytest.fixture(scope="module")
def graph():
    return make_dataset("cora", seed=0, scale=0.1)


def _jax_params(jspec, seed=3):
    return jax.tree_util.tree_map(np.asarray,
                                  init_zoo(jax.random.key(seed), jspec))


def _run_both(graph, arch, *, fused=None, hidden=16, layers=2, heads=2):
    prof = graph.profile
    dims = (prof.feature_dim, hidden, prof.num_classes)
    jspec = JaxSpec(arch, *dims, num_layers=layers, heads=heads)
    tspec = ZooSpec(arch, *dims, num_layers=layers, heads=heads)
    jparams = _jax_params(jspec)
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
    return out, np.asarray(exp)


@pytest.mark.parametrize("arch", ["gin", "gat"])
@pytest.mark.parametrize("fused", [True, False])
def test_forward_matches_reference(graph, arch, fused):
    """Fused or two-stage: gin and gat never take the fused kernel (it
    is gcn's), so both plans give the same result."""
    out, exp = _run_both(graph, arch, fused=fused)
    assert out.shape == exp.shape == (graph.profile.num_nodes,
                                      graph.profile.num_classes)
    np.testing.assert_allclose(out.numpy(), exp, **TOL)


@pytest.mark.parametrize("arch,layers,heads", [
    ("gin", 3, 2), ("gat", 3, 4), ("gat", 1, 2)])
def test_deeper_and_wider_models_match_reference(graph, arch, layers,
                                                 heads):
    out, exp = _run_both(graph, arch, hidden=8, layers=layers, heads=heads)
    np.testing.assert_allclose(out.numpy(), exp, **TOL)


def test_gin_eps_reaches_the_logits(graph):
    """A nonzero ε changes the logits, equally on both sides."""
    prof = graph.profile
    jspec = JaxSpec("gin", prof.feature_dim, 16, prof.num_classes,
                    eps_init=0.7)
    jparams = _jax_params(jspec)
    jgt = jax_build(graph.edges, prof.num_nodes, SHARD_N, "gin")
    tgt = build_graph_tensors(graph.edges, prof.num_nodes, SHARD_N, "gin",
                              "cpu")
    exp = np.asarray(jax_forward(jspec, jparams, jgt,
                                 jgt.group(jnp.asarray(graph.features)),
                                 backend=get_backend("reference")))
    tspec = ZooSpec("gin", prof.feature_dim, 16, prof.num_classes,
                    eps_init=0.7)
    params = params_from_numpy(jparams, "cpu")
    h = tgt.group(torch.from_numpy(graph.features))
    out = forward(tspec, params, tgt, h).numpy()
    np.testing.assert_allclose(out, exp, **TOL)
    params["layers"][0]["eps"] = torch.tensor(0.0)
    assert np.abs(forward(tspec, params, tgt, h).numpy() - out).max() > 1e-3


def _dense_alpha(blocks, s_src, s_dst, slope):
    """A torch copy of the reference's ``_gat_attention_blocks``: the
    masked softmax over the whole (S, S, n, n) grid."""
    mask = blocks != 0
    logits = s_dst[:, None, :, None] + s_src[None, :, None, :]
    logits = F.leaky_relu(logits, slope)
    logits = torch.where(mask, logits, float("-inf"))
    m = torch.amax(logits, dim=(1, 3), keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(mask, torch.exp(logits - m), 0.0)
    denom = torch.sum(e, dim=(1, 3), keepdim=True)
    return torch.where(denom > 0, e / torch.clamp(denom, min=1e-30), 0.0)


@pytest.mark.parametrize("spread", [1.0, 30.0])
def test_gat_alpha_per_nonzero_matches_the_dense_grid(graph, spread):
    """α at each entry of the kept index equals the dense α grid there
    (the reference's and a torch copy of it), and the α grid is zero
    off the index. ``spread`` 30 makes the softmax peaked, so the row
    maximum matters."""
    prof = graph.profile
    tgt = build_graph_tensors(graph.edges, prof.num_nodes, SHARD_N, "gat",
                              "cpu")
    jgt = jax_build(graph.edges, prof.num_nodes, SHARD_N, "gat")
    s, n = tgt.S, tgt.n
    r = np.random.default_rng(5)
    s_src = (r.standard_normal((s, n)) * spread).astype(np.float32)
    s_dst = (r.standard_normal((s, n)) * spread).astype(np.float32)
    z = r.standard_normal((s, n, 4)).astype(np.float32)

    index = tgt.linear_index
    rows = csr.entry_rows(index)
    alpha = gat_attention(index, rows,
                          torch.from_numpy(s_src).reshape(-1, 1),
                          torch.from_numpy(s_dst).reshape(-1, 1), 0.2)[:, 0]
    dense = _dense_alpha(tgt.blocks, torch.from_numpy(s_src),
                         torch.from_numpy(s_dst), 0.2)
    jdense = torch.from_numpy(np.array(_gat_attention_blocks(
        jgt, jnp.asarray(z), jnp.asarray(s_src), jnp.asarray(s_dst), 0.2)))
    col = index.col.long()
    ii, vv = rows // n, rows % n
    jj, uu = col // n, col % n
    for grid in (dense, jdense):
        torch.testing.assert_close(alpha, grid[ii, jj, vv, uu], **TOL)
        off = grid.clone()
        off[ii, jj, vv, uu] = 0.0
        assert off.abs().max().item() == 0.0
    # each real row's weights sum to 1 (every node has its self loop)
    sums = torch.zeros(s * n).index_add_(0, rows, alpha)
    torch.testing.assert_close(sums[: prof.num_nodes],
                               torch.ones(prof.num_nodes), **TOL)
    # the head's aggregation over the α index = the product by the α grid
    zt = torch.from_numpy(z)
    torch.testing.assert_close(
        ref.spmm_indexed(dataclasses.replace(index, val=alpha), zt),
        ref.shard_spmm(dense, zt), **TOL)


def test_init_params_shapes_match_the_reference():
    for arch, heads in (("gin", 2), ("gat", 2), ("gat", 4)):
        jspec = JaxSpec(arch, 12, 8, 3, num_layers=3, heads=heads)
        tspec = ZooSpec(arch, 12, 8, 3, num_layers=3, heads=heads)
        theirs = init_zoo(jax.random.key(0), jspec)
        ours = init_params(tspec, torch.Generator().manual_seed(0), "cpu")
        assert len(ours["layers"]) == len(theirs["layers"]) == 3
        for a, b in zip(ours["layers"], theirs["layers"]):
            assert a.keys() == b.keys()
            for k in a:
                assert tuple(a[k].shape) == tuple(b[k].shape), (arch, k)
                assert a[k].dtype == torch.float32


@pytest.mark.parametrize("arch", ["gin", "gat"])
def test_compile_predict_matches_reference(graph, arch):
    prof = graph.profile
    jspec = JaxSpec(arch, prof.feature_dim, 16, prof.num_classes)
    jparams = _jax_params(jspec, seed=1)
    jexe = jax_runtime.compile(jspec, graph, backend="reference",
                               params=jparams, max_shard_n=SHARD_N)
    exe = runtime.compile(ZooSpec(arch, prof.feature_dim, 16,
                                  prof.num_classes),
                          graph, device="cpu", params=jparams,
                          max_shard_n=SHARD_N)
    np.testing.assert_allclose(exe.forward().numpy(),
                               np.asarray(jexe.forward()), **TOL)
    ids = np.arange(0, prof.num_nodes, 7)
    c1, p1 = exe.predict(ids)
    c2, p2 = jexe.predict(ids)
    np.testing.assert_array_equal(c1, np.asarray(c2))
    np.testing.assert_allclose(p1, np.asarray(p2), **TOL)


def test_server_trace_matches_reference_engine(graph):
    """gin and gat behind the Server, beside gcn, on one request trace:
    the same classes as the reference engine's."""
    prof = graph.profile
    archs = ("gin", "gat", "gcn")
    params = {a: _jax_params(JaxSpec(a, prof.feature_dim, 16,
                                     prof.num_classes), seed=i)
              for i, a in enumerate(archs)}
    jeng = JaxEngine(backend="reference", max_shard_n=SHARD_N)
    jeng.register_graph("cora", graph)
    eng = GNNServeEngine(device="cpu", max_shard_n=SHARD_N)
    eng.register_graph("cora", graph)
    for a in archs:
        jeng.register_model(a, JaxSpec(a, prof.feature_dim, 16,
                                       prof.num_classes), params=params[a])
        eng.register_model(a, ZooSpec(a, prof.feature_dim, 16,
                                      prof.num_classes), params=params[a])
    rng = np.random.default_rng(9)
    trace = [(archs[i % 3], rng.integers(0, prof.num_nodes, size=5))
             for i in range(12)]
    jsrv = JaxServer(jeng, JaxSchedulerConfig(max_batch_size=4))
    srv = Server(eng, SchedulerConfig(max_batch_size=4))
    jt = [jsrv.submit(JaxRequest("cora", ids, m)) for m, ids in trace]
    tt = [srv.submit(NodeRequest("cora", ids, m)) for m, ids in trace]
    for a, b in zip(jt, tt):
        ra, rb = a.result(), b.result()
        assert isinstance(rb, Completed)
        np.testing.assert_array_equal(rb.value.classes, ra.value.classes)
    # gin has its own graph signature; gat shares nothing with gcn
    assert eng.stats["compiles"] == 3
