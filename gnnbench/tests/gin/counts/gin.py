"""Operations and bytes of a GIN layer
act(relu(((1 + ε)·H + A·H)·W1 + b1)·W2 + b2), counted for the inputs at
hand: A as CSR over the N real rows, H (N, D), W1 (D, F), W2 (F, F), the
biases and the output (N, F), all 4-byte words.

The least that any kernel has to do: ``nnz`` counts Â's nonzeros with the
self loops, so the sum's own are at least ``nnz - rows``; a multiply-add
per nonzero and input feature, two operations per row and feature for
(1 + ε)·H + A·H, and the two products; each input read once and the
output written once, no intermediate.
"""
from __future__ import annotations

WORD = 4


def layer_bytes(rows: int, nnz: int, d: int, f: int) -> int:
    edges = max(nnz - rows, 0)
    index = (rows + 1) * WORD + edges * 2 * WORD
    params = (d * f + f * f + 2 * f + 1) * WORD
    return index + params + (rows * d + rows * f) * WORD


def layer_flops(rows: int, nnz: int, d: int, f: int) -> int:
    edges = max(nnz - rows, 0)
    return 2 * edges * d + 2 * rows * d + 2 * rows * d * f + 2 * rows * f * f


def network_bound_s(rows: int, nnz: int, dims: list[int], peaks) -> float:
    """The least time of a whole forward: each layer's larger of its bytes
    at the memory bandwidth and its operations at the float32 rate."""
    return sum(max(layer_bytes(rows, nnz, d, f) / peaks.bytes_per_s,
                   layer_flops(rows, nnz, d, f) / peaks.f32_flops)
               for d, f in zip(dims[:-1], dims[1:]))
