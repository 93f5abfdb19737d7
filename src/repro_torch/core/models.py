"""The paper's GNN benchmarks (Table III): GCN, Graphsage, GraphsagePool.

Functional models: :func:`init_gnn` builds a parameter tree,
:func:`make_forward` runs the forward pass on shard-grouped features
through the GNNerator engines. All three follow the paper's topology —
one hidden layer of dimension 16 by default — but depth and width are
configurable.

GCN        : H' = relu(Â H W)                       (graph-first, fused)
Graphsage  : z̄ = mean_{N(u)∪u} h ; h' = relu(W [z̄; h])   (graph-first)
GraphsagePool: z = relu(W_pool h) ; z̄ = max z ; h' = relu(W [z̄; h])
                                                     (dense-first!)

Kernel launches per forward on the ``cuda`` backend (hidden 16, one
hidden layer): gcn 2 ``fused_gnn``; graphsage 2 ``shard_spmm`` + 2
``dense_engine``; graphsage_pool 4 ``dense_engine`` (pool and concat per
layer) + 2 ``seg_gather``.

The parameter tree ``{"layers": [...]}`` has the reference package's keys
and shapes; its parameters cross through
:func:`repro_torch.gnn.models.params_from_numpy`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core.engines import GNNeratorController, GraphTensors
from repro_torch.core.sharding import shard_graph

# the edge-weight normalization each network bakes into its blocks
NORMALIZE = {"gcn": "gcn", "graphsage": "mean", "graphsage_pool": "max"}


@dataclasses.dataclass(frozen=True)
class GNNSpec:
    kind: str                 # gcn | graphsage | graphsage_pool
    in_dim: int
    hidden_dim: int
    out_dim: int
    num_hidden_layers: int = 1   # paper Table III: 1

    @property
    def layer_dims(self) -> list[tuple[int, int]]:
        dims = ([self.in_dim] + [self.hidden_dim] * self.num_hidden_layers
                + [self.out_dim])
        return list(zip(dims[:-1], dims[1:]))


def _glorot(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def init_gnn(gen: torch.Generator, spec: GNNSpec) -> dict:
    """Glorot-normal parameters drawn from ``gen``, on ``gen.device``.

    The draws differ from ``repro.core.models.init_gnn``'s for the same
    seed; to run both packages on one set of weights, hand the reference
    parameters to :func:`repro_torch.gnn.models.params_from_numpy`."""
    layers = []
    for din, dout in spec.layer_dims:
        if spec.kind == "gcn":
            layer = {"w": _glorot(gen, (din, dout))}
        elif spec.kind == "graphsage":
            layer = {"w": _glorot(gen, (2 * din, dout))}
        elif spec.kind == "graphsage_pool":
            layer = {"w_pool": _glorot(gen, (din, din)),
                     "w": _glorot(gen, (2 * din, dout))}
        else:
            raise ValueError(spec.kind)
        layers.append(layer)
    return {"layers": layers}


def build_graph_tensors(edges: np.ndarray, num_nodes: int, n: int,
                        kind: str, *,
                        device: torch.device | str) -> GraphTensors:
    """Shard + normalize a graph for the given model kind, on ``device``."""
    sg = shard_graph(edges, num_nodes, n, normalize=NORMALIZE[kind],
                     add_self_loops=True)
    return GraphTensors.from_sharded(sg, device)


def make_forward(spec: GNNSpec,
                 controller: GNNeratorController | None = None
                 ) -> Callable[[dict, GraphTensors, torch.Tensor],
                               torch.Tensor]:
    """Build apply(params, gt, h_grouped) -> logits (N, out_dim). The
    controller's engines pick the kernel backend (None: the registry's
    choice per op, ``cuda`` by default)."""
    ctrl = controller or GNNeratorController()
    n_layers = len(spec.layer_dims)

    def apply(params: dict, gt: GraphTensors,
              h: torch.Tensor) -> torch.Tensor:
        # h: (S, n, in_dim) shard-grouped (see GraphTensors.group)
        for i, layer in enumerate(params["layers"]):
            act = "relu" if i < n_layers - 1 else "none"
            if spec.kind == "gcn":
                h = ctrl.graph_first(gt, h, layer["w"], activation=act)
            elif spec.kind == "graphsage":
                agg = ctrl.graph.aggregate(gt, h, op="linear")  # mean norm
                s, n, d = h.shape
                cat = torch.cat([agg, h], dim=-1).reshape(s * n, 2 * d)
                h = ctrl.dense(cat, layer["w"],
                               activation=act).reshape(s, n, -1)
            elif spec.kind == "graphsage_pool":
                zbar = ctrl.dense_first(gt, h, layer["w_pool"],
                                        activation="relu", agg="max")
                s, n, d = h.shape
                cat = torch.cat([zbar, h], dim=-1).reshape(s * n, 2 * d)
                h = ctrl.dense(cat, layer["w"],
                               activation=act).reshape(s, n, -1)
            else:
                raise ValueError(spec.kind)
        return gt.ungroup(h)

    return apply


PAPER_NETWORKS = {  # Table III
    "gcn": dict(kind="gcn", hidden_dim=16, num_hidden_layers=1),
    "graphsage": dict(kind="graphsage", hidden_dim=16, num_hidden_layers=1),
    "graphsage_pool": dict(kind="graphsage_pool", hidden_dim=16,
                           num_hidden_layers=1),
}


def paper_spec(network: str, in_dim: int, num_classes: int) -> GNNSpec:
    cfg = PAPER_NETWORKS[network]
    return GNNSpec(in_dim=in_dim, out_dim=num_classes, **cfg)
