"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def percentile(values, pct: float) -> float:
    """Nearest-rank percentile of all values (no interpolation)."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(pct / 100.0 * len(ordered)) - 1)]


def union_length(intervals) -> float:
    """Length of the union of (start, duration) intervals."""
    total, end = 0.0, None
    for start, dur in sorted(intervals):
        lo, hi = start, start + dur
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total
