"""Plain GCN (Kipf & Welling 2017) in float32 torch: the benchmark's
reference for the ``gcn`` configurations.

Everything the program derives is worked out again here from the edge
list and the weights: the self loops, the normalization
1/sqrt(deg_out(u)·deg_in(v)) (degrees counted with the self loops, each
at least 1; repeated rows add up), the sparse product and the dense
layers. A layer is act((Â·H)·W), relu between layers and none at the
end, and the class probabilities are a float64 softmax of the logits.
The dense products run with TF32 off unless ``tf32`` asks for it (the
control's lower precision).

This module imports nothing of the program.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


def param_shapes(dims: list[int], config: dict) -> list[dict[str, tuple]]:
    """Each layer's tensors, in draw order: W (D_in, D_out) for each pair
    of widths ``dims`` (input, hidden..., classes)."""
    return [{"w": (d, f)} for d, f in zip(dims[:-1], dims[1:])]


def adjacency(edges: np.ndarray, num_nodes: int,
              device: torch.device | str) -> torch.Tensor:
    """Â (N, N) as a float32 sparse CSR tensor: A[v, u] sums the weights
    of the rows (u -> v), self loops added."""
    e = torch.as_tensor(np.asarray(edges, dtype=np.int64), device=device)
    loops = torch.arange(num_nodes, device=device)
    src = torch.cat([e[:, 0], loops])
    dst = torch.cat([e[:, 1], loops])
    deg_in = torch.bincount(dst, minlength=num_nodes).double()
    deg_out = torch.bincount(src, minlength=num_nodes).double()
    w = 1.0 / torch.sqrt(deg_out[src].clamp_min(1.0)
                         * deg_in[dst].clamp_min(1.0))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse")
        a = torch.sparse_coo_tensor(torch.stack([dst, src]), w.float(),
                                    (num_nodes, num_nodes),
                                    check_invariants=False).coalesce()
        return a.to_sparse_csr()


def logits(a: torch.Tensor, features: torch.Tensor, layers: list,
           *, tf32: bool = False) -> torch.Tensor:
    """(N, C) float32 logits of the GCN with ``layers`` [{"w": (D_in,
    D_out)}] over Â ``a`` and (N, F) ``features``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        h = features.float()
        for i, layer in enumerate(layers):
            h = torch.sparse.mm(a, h) @ layer["w"].float()
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
