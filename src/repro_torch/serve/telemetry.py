"""Serving telemetry bundle: the observability surface of the continuous
``Engine`` (port of ``repro/serve/telemetry.py``).

``ServeTelemetry`` groups the pieces the engine reports through:

  * ``registry`` — the ``repro_torch.obs`` metrics registry.  Always
    live: the engine's and scheduler's counters, gauges and histograms
    are their bookkeeping, and ``Engine.stats()`` is a view of it.
  * ``tracer`` — the request-lifecycle event tracer (Chrome trace-event
    export).  Disabled by default; when disabled every hook is a guarded
    no-op.  It runs on the host clock outside the captured CUDA graphs,
    and no span's ``args`` reads a device tensor.
  * ``time_device`` — device-time attribution: the engine synchronizes
    with the card after each step's replay (a replay is asynchronous),
    so device step time and host scheduler time separate per engine step
    (spans on the device track + ``device_*_ms`` histograms).  Off, no
    sync is added.
  * ``drift`` — optional ``DriftMonitor``: online dense-vs-encoded top-1
    logit agreement, sampled every N steps, published as a gauge.
  * ``profile_dir`` — optional ``torch.profiler`` trace directory; the
    engine wraps ``run()`` in ``obs.profiler_trace``.

Track-id layout for the tracer: tid 0 = the engine loop (``step`` spans
with nested ``prefill_chunk``/``decode_step`` spans, or
``draft_step``/``verify_step`` per speculative round), tid 1 = device
time (``device:prefill``/``device:decode``/``device:draft``/
``device:verify`` with ``time_device``), and one track per request
(``req_tid``) carrying its lifecycle — the contiguous ``queued`` →
``prefill`` → ``decode`` phase spans, whose durations sum to the request
latency by construction, plus submit/admit/first-token/evict/stall/COW
instants.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs import DriftMonitor, MetricsRegistry, Tracer

TID_ENGINE = 0
TID_DEVICE = 1
_TID_REQ_BASE = 16


def req_tid(rid: int) -> int:
    """Tracer track id for request ``rid`` (engine/device tracks are
    below the base)."""
    return _TID_REQ_BASE + rid


class ServeTelemetry:
    """Bundle of registry + tracer + attribution/drift/profiler knobs.

    Engines that are handed no telemetry build a disabled one: metrics
    still accumulate (they are the engine's bookkeeping) but the tracer
    is off, no device sync is added, and no profiler runs.
    """

    def __init__(self, *, trace: bool = False, time_device: bool = False,
                 drift: Optional[DriftMonitor] = None,
                 profile_dir: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer(enabled=trace)
        self.time_device = time_device
        self.drift = drift.bind(self.registry) if drift is not None else None
        self.profile_dir = profile_dir
        if self.tracer.enabled:
            self.tracer.thread(TID_ENGINE, "engine")
            self.tracer.thread(TID_DEVICE, "device")

    @classmethod
    def disabled(cls) -> "ServeTelemetry":
        """Metrics-only telemetry (tracer off, no sync, no profiler)."""
        return cls()

    def write(self, trace_out: Optional[str] = None,
              metrics_out: Optional[str] = None,
              trace_jsonl: Optional[str] = None) -> None:
        """Export whatever was asked for (no-op for None paths)."""
        if trace_out:
            self.tracer.write_chrome(trace_out)
        if trace_jsonl:
            self.tracer.write_jsonl(trace_jsonl)
        if metrics_out:
            self.registry.write_json(metrics_out)
