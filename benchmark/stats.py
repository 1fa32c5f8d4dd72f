"""The benchmark's arithmetic: percentiles, rates, the union of device
intervals and the gaps between them."""

from __future__ import annotations

import statistics

import numpy as np


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linearly interpolated
    between the two nearest ranks."""
    if len(values) == 0:
        raise ValueError("percentile of no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def rate(count: int, seconds: float) -> float:
    if seconds <= 0:
        raise ValueError(f"rate over {seconds} s")
    return count / seconds


def merged(intervals, lo: float = float("-inf"), hi: float = float("inf")) -> list:
    """``intervals`` ``(start, end)`` clipped to ``[lo, hi]`` and merged where
    they overlap or touch, in order."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def union_length(intervals, lo: float, hi: float) -> float:
    """The length of ``[lo, hi]`` that some interval covers."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list:
    """The stretches of ``[lo, hi]`` that no interval covers, ``(start, end)``."""
    out, at = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
