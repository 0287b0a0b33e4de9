"""The arithmetic of the metrics: rays, percentiles, unions of intervals."""

from __future__ import annotations

import math


def rays(frames: int, width: int, height: int, hits: float,
         n_lights: int, settings: dict) -> float:
    """Rays of `frames` frames with `hits` hit pixels among them: W*H
    primary rays a frame, one shadow ray per hit and light (with shadows
    on), one AO probe per hit and sample (with AO on)."""
    per_hit = (n_lights if settings["shadows"] else 0) \
        + (settings["ao_samples"] if settings["ao"] else 0)
    return float(frames) * width * height + float(hits) * per_hit


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) of `values`, by linear interpolation
    between the order statistics (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals, lo: float, hi: float) -> float:
    """The length of the union of (start, end) intervals, clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float):
    """The stretches of [lo, hi] that no interval covers, as (start, end)."""
    out, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
