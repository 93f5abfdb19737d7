"""Zoo-model forward pass on the GNNerator engines (runtime internals).

The single implementation behind :meth:`Executable.forward`. Per layer,
a :class:`repro_torch.gnn.executor.LayerPlan` decides whether the two
stages run fused (the aggregate stays in shared memory) or two-stage
through device memory; the kernel backend is passed explicitly, so a
compiled Executable stays pinned to one backend.

gat's attention weights are computed per nonzero of the graph's kept
``linear_index`` (entry k: destination row r, source ``col[k]``) and
walked by the same index with α as its values: the dense (S, S, n, n) α
grid of the reference is zero off the nonzeros, so it is never built.
The masked softmax runs in plain torch, as the reference runs it in jnp.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analyze.op_lint import allow_f64
from repro_torch.core.engines import (DenseEngine, GNNeratorController,
                                      GraphEngine, GraphTensors)
from repro_torch.core.sharding import shard_graph
from repro_torch.gnn.models import ZooSpec, graph_signature
from repro_torch.kernels import csr
from repro_torch.kernels.registry import KernelBackend


def build_graph_tensors(edges: np.ndarray, num_nodes: int, n: int,
                        arch: str, device: torch.device | str
                        ) -> GraphTensors:
    """Shard + normalize a graph for the given zoo architecture."""
    norm, loops = graph_signature(arch)
    sg = shard_graph(edges, num_nodes, n, normalize=norm,
                     add_self_loops=loops)
    return GraphTensors.from_sharded(sg, device)


def layer_activation(spec: ZooSpec, i: int) -> str:
    """Activation for layer i: relu between layers, logits at the end."""
    return "relu" if i < len(spec.layer_dims) - 1 else "none"


def _controller(plan, backend: KernelBackend | None) -> GNNeratorController:
    fused = plan.fused if plan is not None else True
    return GNNeratorController(dense=DenseEngine(backend=backend),
                               graph=GraphEngine(backend=backend),
                               fuse=fused)


def gat_attention(index: csr.LinearIndex, rows: torch.Tensor,
                  s_src: torch.Tensor, s_dst: torch.Tensor,
                  negative_slope: float) -> torch.Tensor:
    """Every head's attention weights α, one row per entry of ``index``.

    The reference's ``_gat_attention_blocks`` at the blocks' nonzeros:
    entry k (destination row ``rows[k]``, source row ``col[k]``) has the
    logit leaky_relu(s_dst[r] + s_src[col[k]]); each destination row
    takes a softmax over its entries. A non-finite row maximum counts as
    0 and a row whose sum is 0 gets α = 0, as in the reference. The row
    maximum only steadies the exponentials, so it carries no gradient.
    Each row's sum is a difference of one float64 prefix sum over the
    row-sorted entries, head after head: on the card a scan adds in one
    order, where ``index_add_``'s atomics would make the forward differ
    run to run; the float64 is deliberate, so it runs inside
    ``allow_f64`` (the dtype pass's DT001 scope). The scan runs over one
    flat vector: torch scans each column of a 2-d tensor down its rows
    in one thread (19.5 ms for gat's two layers at Pubmed on an H100,
    PERF.md).
    s_src/s_dst: (S·n, H) scores. Returns (nnz, H) float32.
    """
    logits = F.leaky_relu(s_dst[rows] + s_src[index.col.long()],
                          negative_slope)
    (nnz, heads), n_rows = logits.shape, index.row_ptr.numel() - 1
    m = torch.full((n_rows, heads), float("-inf"), device=logits.device)
    m = m.scatter_reduce(0, rows[:, None].expand(-1, heads),
                         logits.detach(), reduce="amax", include_self=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(logits - m[rows])                         # (nnz, H)
    ptr = index.row_ptr.long() + nnz * torch.arange(
        heads, device=e.device)[:, None]                    # (H, rows + 1)
    with allow_f64("gat's row sums: a float64 prefix sum keeps the "
                   "forward bitwise repeatable on the card"):
        prefix = F.pad(torch.cumsum(e.t().reshape(-1).double(), 0), (1, 0))
        denom = (prefix[ptr[:, 1:]] - prefix[ptr[:, :-1]]).float().t()[rows]
    return torch.where(denom > 0, e / denom.clamp_min(1e-30), 0.0)


def _gat_layer(spec: ZooSpec, layer: dict, gt: GraphTensors,
               h: torch.Tensor, ctrl: GNNeratorController, *,
               activation: str) -> torch.Tensor:
    s, n, din = h.shape
    heads, hd = layer["a_src"].shape
    z = ctrl.dense(h.reshape(s * n, din), layer["w"])       # (S·n, H·hd)
    z = z.reshape(s * n, heads, hd)
    s_src = torch.einsum("rhf,hf->rh", z, layer["a_src"])
    s_dst = torch.einsum("rhf,hf->rh", z, layer["a_dst"])
    index = gt.linear_index
    alpha = gat_attention(index, csr.entry_rows(index), s_src, s_dst,
                          spec.negative_slope)              # (nnz, H)
    outs = []
    for k in range(heads):      # heads aggregate in turn, as the reference
        outs.append(ctrl.graph.aggregate_indexed(
            dataclasses.replace(index, val=alpha[:, k].contiguous()),
            z[:, k].reshape(s, n, hd).contiguous()))
    out = torch.cat(outs, dim=-1)                           # (S, n, H·hd)
    return torch.relu(out) if activation == "relu" else out


def forward(spec: ZooSpec, params: dict, gt: GraphTensors,
            h: torch.Tensor, *, plans: Sequence | None = None,
            backend: KernelBackend | None = None) -> torch.Tensor:
    """Run the model; h is (S, n, in_dim) shard-grouped (GraphTensors.group).
    Returns (N, out_dim) logits.

    ``plans`` is an optional per-layer sequence of LayerPlans; None uses
    the fused kernel where legal. ``backend=None`` is the registry default.
    """
    for i, layer in enumerate(params["layers"]):
        ctrl = _controller(plans[i] if plans is not None else None, backend)
        act = layer_activation(spec, i)
        s, n, d = h.shape
        if spec.arch == "gcn":
            h = ctrl.graph_first(gt, h, layer["w"], activation=act)
        elif spec.arch == "sage_mean":
            agg = ctrl.graph.aggregate(gt, h, op="linear")  # mean-normalized
            cat = torch.cat([agg, h], dim=-1).reshape(s * n, 2 * d)
            h = ctrl.dense(cat, layer["w"], activation=act).reshape(s, n, -1)
        elif spec.arch == "sage_max":
            zbar = ctrl.dense_first(gt, h, layer["w_pool"], layer["b_pool"],
                                    activation="relu", agg="max")
            cat = torch.cat([zbar, h], dim=-1).reshape(s * n, 2 * d)
            h = ctrl.dense(cat, layer["w"], activation=act).reshape(s, n, -1)
        elif spec.arch == "gin":
            agg = ctrl.graph.aggregate(gt, h, op="linear")  # Σ, no self loop
            x = (1.0 + layer["eps"]) * h + agg
            hid = ctrl.dense(x.reshape(s * n, d), layer["w1"], layer["b1"],
                             activation="relu")
            h = ctrl.dense(hid, layer["w2"], layer["b2"],
                           activation=act).reshape(s, n, -1)
        else:  # gat
            h = _gat_layer(spec, layer, gt, h, ctrl, activation=act)
    return gt.ungroup(h)
