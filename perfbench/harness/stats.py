"""The arithmetic of the metrics: percentiles over every proof, the rate
of a window of whole proofs, and unions and gaps of device intervals."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) by linear interpolation between the
    order statistics (the 'inclusive' rule: 0 is the least, 100 the
    greatest)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window(spans) -> tuple:
    """(open, close) of a window of (start, end) spans: the first start
    and the last end."""
    return min(s for s, _ in spans), max(e for _, e in spans)


def rate(spans, completed: int) -> float:
    """`completed` whole proofs over the length of the window of
    `spans`, every proof started in it."""
    t0, t1 = window(spans)
    return completed / (t1 - t0)


def union(intervals, lo: float, hi: float) -> list:
    """The union of (start, end) intervals clipped to [lo, hi], as
    sorted, disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def covered(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The parts of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for s, e in union(intervals, lo, hi):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def spread(values) -> float:
    """Distance between the first and third quartiles over the median,
    with Python's `statistics.quantiles(values, n=4)`."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
