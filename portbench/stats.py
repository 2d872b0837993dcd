"""The arithmetic of the end-to-end metrics and of the bounds."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value that at
    least ``q`` percent of ``values`` do not exceed."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100 * len(ordered)))
    return ordered[rank - 1]


def rate(units: float, seconds: float) -> float:
    """Units over the whole window's seconds."""
    if seconds <= 0:
        raise ValueError("the window has no length")
    return units / seconds


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
