"""The knobs that decide what a timing means (``repro_torch.env``).

A float32 product on the card runs at float32 accuracy, or on the tensor
cores in TF32 when PyTorch is allowed to (``allow_tf32``, the float32
matmul precision), and cuDNN may pick its algorithms by timing them
(``cudnn.benchmark``). This module is the one place that sets those
knobs: ``chip_smoke.py`` calls :func:`pin_for_benchmarks` before it
measures, and the tuner measures inside :func:`pinned`, which gives the
caller's settings back afterwards. So every recorded number (an
autotuned winner, a smoke run's times) was taken under a pinned
environment that :func:`describe` records beside it.

The reference's ``repro.env`` also pins the jax platform, the host
device count and 64-bit arrays. They have no counterpart here: the
port's device is an explicit argument of every entry point, its dtype is
an explicit float32, and a CPU mesh waits for the port of ``repro.dist``
(ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

import contextlib

import torch


def _state() -> dict:
    return {"tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
            "tf32_cudnn": torch.backends.cudnn.allow_tf32,
            "matmul_precision": torch.get_float32_matmul_precision(),
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def restore(state: dict) -> None:
    """Set every knob back to a snapshot that :func:`configure` returned."""
    torch.backends.cuda.matmul.allow_tf32 = state["tf32_matmul"]
    torch.backends.cudnn.allow_tf32 = state["tf32_cudnn"]
    torch.set_float32_matmul_precision(state["matmul_precision"])
    torch.backends.cudnn.benchmark = state["cudnn_benchmark"]


def configure(*, tf32: bool | None = None,
              matmul_precision: str | None = None) -> dict:
    """Apply any subset of the knobs; returns the snapshot of every knob
    from before, so ``restore(previous)`` undoes it.

    ``tf32``: allow TF32 in float32 matmuls and cuDNN convolutions.
    ``matmul_precision``: ``"highest"``, ``"high"`` or ``"medium"``
    (``torch.set_float32_matmul_precision``)."""
    prev = _state()
    if tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
        torch.backends.cudnn.allow_tf32 = bool(tf32)
    if matmul_precision is not None:
        torch.set_float32_matmul_precision(matmul_precision)
    return prev


def pin_for_benchmarks() -> dict:
    """The pinned measurement environment for benchmarks and tuning runs:
    TF32 off in matmuls and cuDNN, float32 matmul precision
    ``"highest"``, cuDNN's self-timed algorithm choice off. Returns
    :func:`describe` for embedding into the result record."""
    configure(tf32=False, matmul_precision="highest")
    torch.backends.cudnn.benchmark = False
    return describe()


@contextlib.contextmanager
def pinned():
    """:func:`pin_for_benchmarks` for the body of a ``with`` block only:
    the caller's settings come back when it ends, however it ends.
    Yields :func:`describe`."""
    prev = _state()
    try:
        yield pin_for_benchmarks()
    finally:
        restore(prev)


def describe(device: torch.device | str | None = None) -> dict:
    """Snapshot of the environment a measurement ran under. ``device``
    (default: the current card if there is one, else the CPU) names the
    device: ``"cpu"``, or the card's ``torch.cuda.get_device_name``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "capability": (list(torch.cuda.get_device_capability(dev))
                       if on_card else None),
        "device_count": (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0),
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "matmul_precision": torch.get_float32_matmul_precision(),
        "cudnn_benchmark": torch.backends.cudnn.benchmark,
    }
