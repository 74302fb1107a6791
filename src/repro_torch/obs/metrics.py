"""Metrics registry: Counter / Gauge / Histogram with label support (port
of ``repro/obs/metrics.py``; the same operations give the same
``snapshot()`` JSON in both packages).

The continuous engine's single source of numeric truth: the ``Engine``
and its ``Scheduler`` increment these instead of a raw dict,
``Engine.stats()`` reads them back, and ``launch/serve.py
--metrics-out`` dumps the whole registry as one JSON document.

Design points:

  * **Labels** are kwargs at observation time (``c.inc(1, mac="fp")``);
    each distinct label set is an independent series under the metric.
  * **Histogram** keeps BOTH fixed-bucket counts (cheap, exportable,
    mergeable) and the raw samples, so exported p50/p95/p99 are *exact*
    order statistics (via ``obs.stats.percentile``) rather than bucket
    upper bounds.  Samples are one float each; serving runs observe a
    few values per engine step, so memory stays trivially bounded.
  * Metric creation is **get-or-create** keyed by name: two subsystems
    asking for the same counter share one series (re-registering with a
    different type raises).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from .stats import percentile

# seconds-to-milliseconds scale latencies land well in these
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _lkey(labels: dict) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _lstr(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key) if key else ""


class Metric:
    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def label_keys(self) -> List[LabelKey]:
        raise NotImplementedError

    def series(self) -> dict:
        raise NotImplementedError


class Counter(Metric):
    """Monotonically increasing value (float increments allowed)."""
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._v: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative inc {n}")
        k = _lkey(labels)
        self._v[k] = self._v.get(k, 0.0) + n

    def value(self, **labels) -> float:
        return self._v.get(_lkey(labels), 0.0)

    def total(self) -> float:
        """Sum across every label series."""
        return sum(self._v.values())

    def series(self) -> dict:
        return {_lstr(k): v for k, v in self._v.items()}


class Gauge(Metric):
    """Last-write-wins value (pool occupancy, queue depth, drift)."""
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._v: Dict[LabelKey, float] = {}

    def set(self, v: float, **labels) -> None:
        self._v[_lkey(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        k = _lkey(labels)
        self._v[k] = self._v.get(k, 0.0) + n

    def value(self, **labels) -> float:
        return self._v.get(_lkey(labels), float("nan"))

    def series(self) -> dict:
        return {_lstr(k): v for k, v in self._v.items()}


class _HistSeries:
    __slots__ = ("counts", "samples", "sum")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)      # +1 = +Inf overflow
        self.samples: List[float] = []
        self.sum = 0.0


class Histogram(Metric):
    """Fixed-bucket histogram that also retains raw samples, so the
    exported percentiles are exact (nearest-rank-interpolated over the
    sample, not bucket bounds)."""
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name}: empty buckets")
        self._s: Dict[LabelKey, _HistSeries] = {}

    def observe(self, v: float, **labels) -> None:
        k = _lkey(labels)
        s = self._s.get(k)
        if s is None:
            s = self._s[k] = _HistSeries(len(self.buckets))
        i = len(self.buckets)                    # overflow bucket
        for j, ub in enumerate(self.buckets):
            if v <= ub:
                i = j
                break
        s.counts[i] += 1
        s.samples.append(float(v))
        s.sum += v

    def count(self, **labels) -> int:
        s = self._s.get(_lkey(labels))
        return len(s.samples) if s is not None else 0

    def samples(self, **labels) -> List[float]:
        """A copy of one series' raw samples, in observation order."""
        s = self._s.get(_lkey(labels))
        return list(s.samples) if s is not None else []

    def percentile(self, q: float, **labels) -> float:
        s = self._s.get(_lkey(labels))
        return percentile(s.samples if s is not None else (), q)

    def summary(self, **labels) -> dict:
        s = self._s.get(_lkey(labels))
        if s is None or not s.samples:
            return {"count": 0, "sum": 0.0}
        xs = sorted(s.samples)
        out = {"count": len(xs), "sum": s.sum, "min": xs[0], "max": xs[-1],
               "p50": percentile(xs, 50), "p95": percentile(xs, 95),
               "p99": percentile(xs, 99)}
        bounds = [str(b) for b in self.buckets] + ["+Inf"]
        out["buckets"] = dict(zip(bounds, s.counts))
        return out

    def series(self) -> dict:
        return {_lstr(k): self.summary(**dict(k)) for k in self._s}


class MetricsRegistry:
    """Get-or-create registry of named metrics with one JSON export."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """One nested dict for the whole registry — the schema
        ``--metrics-out`` writes."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in self.names():
            m = self._metrics[name]
            group = {"counter": "counters", "gauge": "gauges",
                     "histogram": "histograms"}[m.kind]
            out[group][name] = {"help": m.help, "series": m.series()}
        return out

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, default=float)
