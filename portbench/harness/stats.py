"""The arithmetic of the end-to-end metrics."""
from __future__ import annotations

import math


def rays_per_s(width: int, height: int, bounces: int, passes: int,
               seconds: float) -> float:
    """Pixels x passes x bounces over all passes of the window, divided
    by the window's whole time."""
    return width * height * passes * bounces / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100), by linear interpolation between
    order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
