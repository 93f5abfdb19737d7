"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates at the full 700 W power limit)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    bytes_per_s: float      # HBM bandwidth
    f32_flops: float        # float32 outside the tensor cores


H100_SXM = Peaks("NVIDIA H100 SXM", bytes_per_s=3.35e12, f32_flops=67e12)


def for_device(kind: str) -> Peaks | None:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a device without a table (no share of a peak is read
    there)."""
    return H100_SXM if "H100" in kind else None
