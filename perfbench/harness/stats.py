"""The arithmetic of the end-to-end metrics and of the device trace.

Every statistic runs over every frame of the window: no frame is dropped
and no chunk is averaged first.
"""
from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """The nearest-rank `q`-th percentile: the smallest value with at least
    q % of the values at or below it."""
    v = np.sort(np.asarray(values, np.float64))
    if len(v) == 0:
        return math.nan
    return float(v[max(0, math.ceil(q / 100.0 * len(v)) - 1)])


def frame_latencies_ms(request_s, done_ms) -> np.ndarray:
    """Each frame's latency: from its request (host seconds since the
    window's start) to the device completing its work (milliseconds since
    the window's start event)."""
    return np.asarray(done_ms, np.float64) - np.asarray(request_s, np.float64) * 1e3


def fps(n_frames: int, window_s: float) -> float:
    """Frames handed in during the window over its wall time."""
    return n_frames / window_s


def union(starts, ends):
    """Merge intervals: (starts, ends) of the disjoint union, in order."""
    s = np.asarray(starts, np.int64)
    e = np.asarray(ends, np.int64)
    if len(s) == 0:
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(reach[idx[1:] - 1], reach[-1])


def clip(starts, ends, lo: int, hi: int):
    """Intervals cut to [lo, hi], empty ones dropped."""
    s = np.clip(np.asarray(starts, np.int64), lo, hi)
    e = np.clip(np.asarray(ends, np.int64), lo, hi)
    keep = e > s
    return s[keep], e[keep]


def busy_ns(starts, ends, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] covered by at least one interval."""
    s, e = union(*clip(starts, ends, lo, hi))
    return int(np.sum(e - s))


def gaps(starts, ends, lo: int, hi: int):
    """The idle gaps of [lo, hi]: (starts, ends) of the time no interval
    covers."""
    s, e = union(*clip(starts, ends, lo, hi))
    gs = np.concatenate([[lo], e])
    ge = np.concatenate([s, [hi]])
    keep = ge > gs
    return gs[keep], ge[keep]
