"""Zoo-model forward pass on the GNNerator engines (runtime internals).

The single implementation behind :meth:`Executable.forward`. Per layer,
a :class:`repro_torch.gnn.executor.LayerPlan` decides whether the two
stages run fused (the aggregate stays in shared memory) or two-stage
through device memory; the kernel backend is passed explicitly, so a
compiled Executable stays pinned to one backend.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.engines import (DenseEngine, GNNeratorController,
                                      GraphEngine, GraphTensors)
from repro_torch.core.sharding import shard_graph
from repro_torch.gnn.models import ZooSpec, graph_signature
from repro_torch.kernels.registry import KernelBackend

SUPPORTED_ARCHS = ("gcn", "sage_mean", "sage_max")


def check_arch(arch: str) -> None:
    """Raise NotImplementedError for a zoo arch this package cannot run."""
    if arch not in SUPPORTED_ARCHS:
        raise NotImplementedError(
            f"{arch} is not ported yet: this package runs {SUPPORTED_ARCHS} "
            f"(gin and gat are ROADMAP.md Queue 1, item 1)")


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


def forward(spec: ZooSpec, params: dict, gt: GraphTensors,
            h: torch.Tensor, *, plans: Sequence | None = None,
            backend: KernelBackend | None = None) -> torch.Tensor:
    """Run the model; h is (S, n, in_dim) shard-grouped (GraphTensors.group).
    Returns (N, out_dim) logits.

    ``plans`` is an optional per-layer sequence of LayerPlans; None uses
    the fused kernel where legal. ``backend=None`` is the registry default.
    """
    check_arch(spec.arch)
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
        else:  # sage_max
            zbar = ctrl.dense_first(gt, h, layer["w_pool"], layer["b_pool"],
                                    activation="relu", agg="max")
            cat = torch.cat([zbar, h], dim=-1).reshape(s * n, 2 * d)
            h = ctrl.dense(cat, layer["w"], activation=act).reshape(s, n, -1)
    return gt.ungroup(h)
