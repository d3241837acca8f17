"""Window arithmetic: percentiles and rates."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by the nearest rank:
    the smallest value with at least q% of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def rate(count: float, t0: float, t1: float) -> float:
    """``count`` over the window [t0, t1] (seconds)."""
    if t1 <= t0:
        raise ValueError(f"empty window [{t0}, {t1}]")
    return count / (t1 - t0)

