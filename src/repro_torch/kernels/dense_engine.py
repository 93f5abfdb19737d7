"""Dense Engine: ``act(x @ w + b)``.

The port of ``repro.kernels.dense_engine.dense_engine_matmul``; the CUDA
kernel is ``csrc/dense_engine.cu``, a float32 GEMM on the tensor cores
(three TF32 products per step, float32 accuracy) with the bias and
activation in its epilogue. CPU tensors take the plain version in
``ref.py``; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref
from repro_torch.kernels.fused_gnn import ACTIVATIONS

_PLANES_FLOATS = 3 * 128 * 32  # csrc wide::B_BYTES / 4


def dense_engine_matmul(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor | None = None, *,
                        activation: str = "none") -> torch.Tensor:
    """x (M, K), w (K, N), b (N,) or None, all float32 -> (M, N)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation}")
    tensors = (x, w) if b is None else (x, w, b)
    if _lib.on_cpu(*tensors):
        return ref.dense_engine(x, w, b, activation=activation)
    _lib.check("dense_engine", "x", x, torch.float32, 2)
    _lib.check("dense_engine", "w", w, torch.float32, 2)
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"dense_engine: x {tuple(x.shape)} does not match "
                         f"w {tuple(w.shape)}")
    if b is not None:
        _lib.check("dense_engine", "b", b, torch.float32, 1)
        if b.shape[0] != n:
            raise ValueError(f"dense_engine: b {tuple(b.shape)} does not "
                             f"match w {tuple(w.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel():
        # N > 32: w's split planes, 48 KB per (128-column tile, 32-deep
        # K slice), written by the kernel's first pass
        scratch = None
        if n > 32:
            scratch = torch.empty(
                -(-n // 128) * -(-k // 32) * _PLANES_FLOATS,
                dtype=torch.float32, device=x.device)
        _lib.launch("dense_engine", x, w, b, scratch, out, m, n, k,
                    ACTIVATIONS[activation], device=x.device)
    return out
