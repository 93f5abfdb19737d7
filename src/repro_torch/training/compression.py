"""Gradient compression with error feedback for the data-parallel
all-reduce: the port of ``repro.training.compression``.

int8 per-tensor symmetric quantization: gradients are quantized before
the data-parallel reduction (8x less wire traffic on that axis) and the
quantization residual is carried to the next step (error feedback, which
keeps SGD/Adam convergence robust to the compression; Karimireddy et
al. 2019). What the optimizer sees is the dequantized gradient; this
module computes exactly that, bit for bit as the reference does
(``torch.round`` and ``jnp.round`` both round half to even), and moves
no bytes itself.

Trees are dicts, lists and tuples of tensors, walked as
:mod:`repro_torch.training.optimizer` walks them.
"""
from __future__ import annotations

import torch

from repro_torch.training.optimizer import tree_leaves, tree_unflatten


def _quantize(g32: torch.Tensor):
    amax = torch.max(torch.abs(g32))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(grads, err_feedback=None):
    """Returns (dequantized grads in their own dtypes, new error-feedback
    tree in float32). ``err_feedback`` None starts from no residual."""
    def one(g, e):
        g32 = g.to(torch.float32)
        if e is not None:
            g32 = g32 + e
        q, scale = _quantize(g32)
        deq = _dequantize(q, scale)
        return deq.to(g.dtype), g32 - deq

    flat_g = tree_leaves(grads)
    flat_e = [None] * len(flat_g) if err_feedback is None \
        else tree_leaves(err_feedback)
    outs = [one(g, e) for g, e in zip(flat_g, flat_e)]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def wire_bytes_saved(grads) -> float:
    """8x on the data-parallel axis: a float32 payload becomes int8 (plus
    one float32 scale a tensor)."""
    leaves = tree_leaves(grads)
    total = sum(t.numel() for t in leaves)
    return total * 4 - (total * 1 + len(leaves) * 4)
