"""Arithmetic of the window's numbers."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest value
    with at least q % of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]


def tail_percentile(values: Sequence[float], q: float,
                    beyond: int = 10) -> Optional[float]:
    """The q-th percentile where at least `beyond` values lie above its
    rank, else None."""
    n = len(values)
    if n == 0 or n - max(1, math.ceil(q / 100.0 * n)) < beyond:
        return None
    return percentile(values, q)
