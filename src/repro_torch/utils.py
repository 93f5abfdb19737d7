"""Small shared utilities."""
from __future__ import annotations

import numpy as np
import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pad_to(x, size: int, axis: int = 0, value=0.0):
    """Pad a numpy array or a tensor along ``axis`` up to ``size`` (the
    same kind comes back; ``x`` itself when it is already that long)."""
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    if isinstance(x, np.ndarray):
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, pad)
        return np.pad(x, widths, constant_values=value)
    # F.pad lists (before, after) pairs from the last axis backwards
    widths = [0, 0] * (x.ndim - axis % x.ndim - 1) + [0, pad]
    return torch.nn.functional.pad(x, widths, value=value)


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PiB"
