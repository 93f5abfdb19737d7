"""GNN model zoo specs and parameters (VersaGNN-style coverage).

Every architecture is assembled from the paper's two engines — the Dense
Engine (blocked matmul + activation unit) and the Graph Engine (shard-grid
aggregation) — composed by the GNNeratorController (core/engines.py).

Architectures (all multi-layer, relu between layers, logits at the end):

  gcn        H' = act(Â H W)                       graph-first, fusable
  sage_mean  H' = act(W [mean_N∪u(H); H])          graph-first
  sage_max   z = relu(H W_p + b_p); z̄ = max_N z;
             H' = act(W [z̄; H])                    dense-first (pool)
  gin        H' = MLP((1+ε) H + Σ_N H)             graph-first, ε learnable
  gat        H' = act(‖_heads Σ_u α_vu z_u)        attention-weighted shard
                                                   SpMM (α per nonzero of
                                                   the graph's kept index)

Parameters are a plain dict ``{"layers": [per-layer dict of tensors]}``
with the reference package's key names and shapes, so parameters cross
between the two packages through numpy (:func:`params_from_numpy`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

ARCHS = ("gcn", "sage_mean", "sage_max", "gin", "gat")

# arch -> (edge-weight normalization baked into the shard blocks,
#          add self loops when sharding)
_GRAPH_SIG = {
    "gcn": ("gcn", True),
    "sage_mean": ("mean", True),
    "sage_max": ("sum", True),    # gather path; binary blocks
    "gin": ("sum", False),        # (1+ε)·h term replaces the self loop
    "gat": ("sum", True),         # binary mask; α supplies the weights
}


def graph_signature(arch: str) -> tuple[str, bool]:
    """(normalize, add_self_loops) a model needs its GraphTensors built with.

    Two models with the same signature share one sharded graph build.
    """
    return _GRAPH_SIG[arch]


@dataclasses.dataclass(frozen=True)
class ZooSpec:
    arch: str
    in_dim: int
    hidden_dim: int
    out_dim: int
    num_layers: int = 2
    heads: int = 2                 # GAT hidden layers (output layer: 1 head)
    eps_init: float = 0.0          # GIN ε initial value (learnable)
    negative_slope: float = 0.2    # GAT LeakyReLU

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"unknown arch {self.arch!r}; choose {ARCHS}")
        if self.num_layers < 1:
            raise ValueError("need at least one layer")
        if self.arch == "gat" and self.hidden_dim % self.heads:
            raise ValueError("gat: hidden_dim must divide by heads")

    @property
    def layer_dims(self) -> list[tuple[int, int]]:
        dims = ([self.in_dim] + [self.hidden_dim] * (self.num_layers - 1)
                + [self.out_dim])
        return list(zip(dims[:-1], dims[1:]))

    def agg_dim(self, layer: int) -> int:
        """Feature dim live at aggregation time (what the planner blocks)."""
        din, dout = self.layer_dims[layer]
        if self.arch == "gat":
            return dout
        return din


def _glorot(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    scale = (2.0 / (fan_in + fan_out)) ** 0.5
    return torch.randn(shape, generator=gen, dtype=torch.float32) * scale


def init_params(spec: ZooSpec, gen: torch.Generator,
                device: torch.device | str) -> dict:
    """Glorot-normal parameters drawn from ``gen`` (a CPU generator, so
    the numbers do not depend on the device), placed on ``device``.

    The draws differ from ``repro.gnn.models.init_zoo``'s for the same
    seed; to run both packages on one set of weights, hand the reference
    parameters to :func:`params_from_numpy`.
    """
    layers = []
    for i, (din, dout) in enumerate(spec.layer_dims):
        if spec.arch == "gcn":
            layer = {"w": _glorot(gen, (din, dout))}
        elif spec.arch == "sage_mean":
            layer = {"w": _glorot(gen, (2 * din, dout))}
        elif spec.arch == "sage_max":
            layer = {"w_pool": _glorot(gen, (din, din)),
                     "b_pool": torch.zeros((din,), dtype=torch.float32),
                     "w": _glorot(gen, (2 * din, dout))}
        elif spec.arch == "gin":
            layer = {"eps": torch.tensor(spec.eps_init, dtype=torch.float32),
                     "w1": _glorot(gen, (din, dout)),
                     "b1": torch.zeros((dout,), dtype=torch.float32),
                     "w2": _glorot(gen, (dout, dout)),
                     "b2": torch.zeros((dout,), dtype=torch.float32)}
        else:  # gat: `heads` on hidden layers, 1 on the output layer
            heads = spec.heads if i < spec.num_layers - 1 else 1
            hd = dout // heads
            if heads * hd != dout:
                raise ValueError(f"gat layer {i}: {dout} !% {heads} heads")
            layer = {"w": _glorot(gen, (din, heads * hd)),
                     "a_src": _glorot(gen, (heads, hd)),
                     "a_dst": _glorot(gen, (heads, hd))}
        layers.append(layer)
    return params_from_numpy({"layers": layers}, device)


def params_from_numpy(tree, device: torch.device | str):
    """Turn a parameter tree of arrays (numpy, anything ``np.asarray``
    accepts, or tensors) into float32 tensors on ``device``, keeping the
    dict/list structure — e.g. the reference package's
    ``{"layers": [...]}`` pytree."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    # copy: the source may be a read-only view (a JAX array's buffer)
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)
