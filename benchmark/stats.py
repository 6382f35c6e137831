"""The arithmetic of the end-to-end metrics: rates over the whole window and
percentiles over all requests (a request that failed or never answered
counts as infinitely late)."""

from __future__ import annotations

import math
from typing import Sequence


def rate(units: float, seconds: float) -> float:
    """Units completed per second over the whole window."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks, numpy's default; ``inf`` counts as larger than any time."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
