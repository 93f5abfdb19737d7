"""Fused Graph Engine -> Dense Engine layer: ``act(A · H · W)``.

The port of ``repro.kernels.fused_gnn.fused_gnn_layer``. The blocks'
nonzeros are first listed by destination row (``csr.linear_index``,
plain torch on the tensors' device, built once per graph by
``core.engines.GraphTensors``); the CUDA kernel ``csrc/fused_gnn.cu``
then takes the product in the cheaper order and aggregates once, at the
narrower width (:func:`route`): for D > F it projects first, Z = H · W
into a workspace and then act(A · Z), and otherwise it gathers each
destination row's D-wide aggregate and multiplies it by W on the chip.
Both orders are one launch. CPU tensors take the plain version in
``ref.py``, which keeps the reference's (A · H) · W; CUDA tensors launch
the kernel or raise.
"""
from __future__ import annotations

import threading

import torch

from repro_torch.kernels import _lib, csr, ref
from repro_torch.kernels.csr import LinearIndex, linear_index

ACTIVATIONS = {"none": 0, "relu": 1, "gelu": 2, "silu": 3}

PROJECT_FIRST, AGGREGATE_FIRST = "project_first", "aggregate_first"

_lock = threading.Lock()
_routes = dict.fromkeys((PROJECT_FIRST, AGGREGATE_FIRST), 0)


def route(d: int, f: int) -> str:
    """The kernel's order for a (D, F) layer, from the shape alone: the
    aggregation runs at the narrower width, so D > F projects first,
    act(A · (H · W)), and D <= F aggregates first, act((A · H) · W)."""
    return PROJECT_FIRST if d > f else AGGREGATE_FIRST


def routes() -> dict[str, int]:
    """Kernel launches by order (``project_first``, ``aggregate_first``)
    since the last :func:`reset_routes`; the plain CPU version counts
    nothing."""
    with _lock:
        return dict(_routes)


def reset_routes() -> None:
    with _lock:
        for k in _routes:
            _routes[k] = 0


def fused_gnn_layer(blocks: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                    *, activation: str = "none",
                    index: LinearIndex | None = None) -> torch.Tensor:
    """blocks (S, S, n, n), h (S, n, D), w (D, F), all float32 ->
    (S, n, F).

    ``index``: the blocks' :func:`~repro_torch.kernels.csr.linear_index`,
    if the caller keeps one; without it the index is built here (a sync
    with the host). The result is the same. The kernel reads only the
    blocks' nonzeros, so it equals the full product only for finite
    ``h``: where ``h`` holds Inf or NaN behind a zero of the blocks, the
    plain version gives NaN and the kernel does not."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation}")
    extra = () if index is None else (index.row_ptr, index.col, index.val,
                                      index.hubs)
    if _lib.on_cpu(blocks, h, w, *extra):
        return ref.fused_gnn(blocks, h, w, activation=activation)
    _lib.check("fused_gnn", "blocks", blocks, torch.float32, 4)
    _lib.check("fused_gnn", "h", h, torch.float32, 3)
    _lib.check("fused_gnn", "w", w, torch.float32, 2)
    s, s2, n, n2 = blocks.shape
    s3, n3, d = h.shape
    d2, f = w.shape
    if not (s == s2 == s3 and n == n2 == n3 and d == d2):
        raise ValueError(f"fused_gnn: shapes do not match: blocks "
                         f"{tuple(blocks.shape)}, h {tuple(h.shape)}, "
                         f"w {tuple(w.shape)}")
    if index is None:
        index = linear_index(blocks)
    csr.check_linear_index("fused_gnn", index, s * n)
    out = torch.empty((s, n, f), dtype=torch.float32, device=h.device)
    if out.numel():
        order = route(d, f)
        project = order == PROJECT_FIRST
        # Z (rows, F rounded up to 4) when projecting first, then the
        # kernel's two work counters, in 4 words
        z = s * n * -(-f // 4) * 4 if project else 0
        work = torch.empty(z + 4, dtype=torch.float32, device=h.device)
        _lib.launch("fused_gnn", index.row_ptr, index.col, index.val,
                    index.hubs, h, w, out, work, s * n, d, f,
                    ACTIVATIONS[activation], index.col.numel(),
                    index.hubs.numel(), csr.HUB_ENTRIES, int(project),
                    device=h.device)
        with _lock:
            _routes[order] += 1
    return out
