"""Operations and bytes of a GCN layer act(Â·H·W), counted for the
inputs at hand: Â as CSR over the N real rows (row offsets, column ids
and values), H (N, D), W (D, F) and the output (N, F), all 4-byte words.

These are the least that any kernel has to do on these inputs, whatever
order it takes the product in:

- operations at the cheaper association: the aggregation runs at the
  narrower of the two widths, (Â·H)·W when D <= F and Â·(H·W) when
  D > F, so a multiply-add per nonzero and min(D, F) features, and the
  extraction one per row, input feature and output feature;
- bytes with each input read once and the output written once. The
  graph-first order needs no intermediate in memory (a row's aggregate
  meets W on the chip), so none is counted.

Padding rows and re-reads are not work. The bound takes the larger of
the two, so it holds under every kernel, also one that projects first.
"""
from __future__ import annotations

WORD = 4


def layer_bytes(rows: int, nnz: int, d: int, f: int) -> int:
    index = (rows + 1) * WORD + nnz * 2 * WORD
    return index + (rows * d + d * f + rows * f) * WORD


def layer_flops(rows: int, nnz: int, d: int, f: int) -> int:
    return 2 * nnz * min(d, f) + 2 * rows * d * f


def layer_bound_s(rows: int, nnz: int, d: int, f: int, peaks) -> float:
    """The least time the chip could take for one layer: the larger of
    its bytes at the memory bandwidth and its operations at the float32
    rate (the program computes in float32 on the CUDA cores)."""
    return max(layer_bytes(rows, nnz, d, f) / peaks.bytes_per_s,
               layer_flops(rows, nnz, d, f) / peaks.f32_flops)


def network_layers(rows: int, nnz: int, dims: list[int]) -> list[tuple]:
    """(rows, nnz, d, f) of each layer of a GCN of widths ``dims``
    (input, hidden..., classes) on one graph."""
    return [(rows, nnz, d, f) for d, f in zip(dims[:-1], dims[1:])]


def network_bound_s(rows: int, nnz: int, dims: list[int], peaks) -> float:
    """The least time of a whole forward: every layer's bound, the last
    one writing the logits the softmax reads."""
    return sum(layer_bound_s(*layer, peaks)
               for layer in network_layers(rows, nnz, dims))
