"""The benchmark's arithmetic on what the runs report: the rate over the
whole window, the tail of the step intervals, and the union of device
intervals that the idle share reads."""

from __future__ import annotations

import statistics


def window_rate(steps: list[int], start: float, ends: list[float]) -> float:
    """Every step that all runs completed, over the window from the common
    start to the last run's end (its drain included)."""
    return sum(steps) / (max(ends) - start)


def p95(values) -> float:
    """The 95th percentile of all values (``statistics.quantiles``, the
    'exclusive' method, of 100 parts)."""
    values = list(values)
    if len(values) < 2:
        raise ValueError("a percentile needs at least two values")
    return statistics.quantiles(values, n=100)[94]


def union_length(intervals, lo=None, hi=None) -> float:
    """The length of the union of ``(start, end)`` intervals, each clipped
    to ``[lo, hi]`` where given."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if lo is not None:
            a = max(a, lo)
        if hi is not None:
            b = min(b, hi)
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def gaps(intervals, lo, hi):
    """The idle gaps ``(start, end)`` between the union of ``intervals``
    inside ``[lo, hi]``."""
    out, t = [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out
