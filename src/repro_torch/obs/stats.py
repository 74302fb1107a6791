"""Shared order statistics for serving reports (port of
``repro/obs/stats.py``).

The port's one percentile implementation: ``Engine.stats()``,
``ServeEngine.stats()`` and the metrics registry's histograms read it.
It linearly interpolates between closest ranks with the reference's
formula, so it gives ``repro.obs.percentile``'s values bit for bit and
``numpy.percentile(..., method='linear')``'s within the last bit (numpy
interpolates from the nearer rank; both asserted in
``tests/test_torch_telemetry.py``), and returns NaN on an empty sample
instead of raising, so reporting code never has to special-case a
drained engine.
"""
from __future__ import annotations

import math
from typing import Iterable, Sequence


def percentile(xs: Iterable[float], q: float) -> float:
    """q-th percentile (``q`` in [0, 100]) with linear interpolation
    between closest ranks; NaN for an empty sample."""
    xs = sorted(xs)
    if not xs:
        return float("nan")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    rank = (q / 100.0) * (len(xs) - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return float(xs[lo])
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


def percentiles(xs: Sequence[float], qs: Iterable[float]) -> dict:
    """Several percentiles of one (sorted-once) sample: {q: value}."""
    xs = sorted(xs)
    return {q: percentile(xs, q) for q in qs}
