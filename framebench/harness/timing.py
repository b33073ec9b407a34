"""The benchmark's own arithmetic of times: the window's frame time, the
tail of its frame intervals, the union of device intervals and the idle
gaps. Copied here from the port's bench and profile tools, so that a
change to the program cannot move it."""

from __future__ import annotations

import math


def frame_ms(window_s: float, frames: int) -> float:
    """The window's seconds over the frames completed in it, in ms."""
    if frames <= 0:
        raise ValueError("no frame completed in the window")
    return window_s * 1e3 / frames


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all `values`."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[rank - 1])


def intervals_ms(stamps_ms) -> list:
    """Successive differences of frame-end times."""
    return [b - a for a, b in zip(stamps_ms, stamps_ms[1:])]


def union(spans) -> list:
    """The union of (start, end) spans as sorted disjoint spans."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(spans, lo: float, hi: float) -> float:
    """The length of the union of `spans` clipped to [lo, hi]."""
    total = 0.0
    for s, e in union(spans):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def gaps(spans, lo: float, hi: float) -> list:
    """The (start, end) stretches of [lo, hi] that no span covers."""
    out, cur = [], lo
    for s, e in union(spans):
        if e <= lo or s >= hi:
            continue
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out
