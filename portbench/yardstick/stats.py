"""Statistics of the end-to-end metrics."""

from __future__ import annotations

import math


def percentile(values, p):
    """The nearest-rank ``p``-th percentile: the smallest value with at
    least ``p`` percent of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    k = max(1, math.ceil(p / 100.0 * len(v)))
    return v[k - 1]


def units_per_s(ctx, unit):
    """Units of ``unit`` handed over per second of the window (``None`` in
    a run whose calls hand over another unit)."""
    if ctx.unit != unit or ctx.window_s <= 0:
        return None
    return sum(n for _, _, n in ctx.records) / ctx.window_s
