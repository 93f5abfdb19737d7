"""Plain GIN (Xu et al. 2019, arXiv:1810.00826) in float32 torch: a
reference for ``gin`` configurations, after the program's documented
layer

    H' = act(relu(((1 + ε)·H + Σ_{u -> v} H_u)·W1 + b1)·W2 + b2)

with relu between layers and none at the end; the class probabilities
are a float64 softmax of the logits. The sum runs over the edge list as
given, repeated rows adding up, with no self loops: the (1 + ε)·H term
stands in for them. The dense products run with TF32 off unless
``tf32`` asks for it (the control's lower precision).

This module imports nothing of the program.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


def param_shapes(dims: list[int], config: dict) -> list[dict[str, tuple]]:
    """Each layer's tensors, in draw order, under the program's key
    names: ε, then the two-layer MLP (D_in -> D_out -> D_out)."""
    return [{"eps": (), "w1": (d, f), "b1": (f,), "w2": (f, f), "b2": (f,)}
            for d, f in zip(dims[:-1], dims[1:])]


def adjacency(edges: np.ndarray, num_nodes: int,
              device: torch.device | str) -> torch.Tensor:
    """A (N, N) as a float32 sparse CSR tensor: A[v, u] counts the rows
    (u -> v); no self loops."""
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64), device=device)
    ones = torch.ones(e.shape[0], device=device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse")
        a = torch.sparse_coo_tensor(torch.stack([e[:, 1], e[:, 0]]), ones,
                                    (num_nodes, num_nodes),
                                    check_invariants=False).coalesce()
        return a.to_sparse_csr()


def logits(a: torch.Tensor, features: torch.Tensor, layers: list,
           *, tf32: bool = False) -> torch.Tensor:
    """(N, C) float32 logits of the GIN with ``layers`` over A ``a`` and
    (N, F) ``features``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        h = features.float()
        for i, layer in enumerate(layers):
            x = (1.0 + layer["eps"].float()) * h + torch.sparse.mm(a, h)
            hid = torch.relu(x @ layer["w1"].float() + layer["b1"].float())
            h = hid @ layer["w2"].float() + layer["b2"].float()
            if i < len(layers) - 1:
                h = torch.relu(h)
        return h
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def probs(a: torch.Tensor, features: torch.Tensor, layers: list,
          *, tf32: bool = False) -> torch.Tensor:
    """(N, C) float64 class probabilities."""
    return torch.softmax(logits(a, features, layers, tf32=tf32).double(),
                         dim=-1)
