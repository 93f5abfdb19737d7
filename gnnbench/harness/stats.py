"""The spread of a set of runs, as the bounds are set from it."""
from __future__ import annotations

import statistics
from typing import Sequence


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
