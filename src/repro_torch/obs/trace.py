"""Request-lifecycle event tracer: Chrome trace-event JSON + JSONL (port
of ``repro/obs/trace.py``).

Records timestamped spans and instants for the serving engine on the
host clock, outside the captured CUDA graphs, and exports them in the Chrome trace-event format, so a
serving run can be opened directly in Perfetto (https://ui.perfetto.dev)
or ``chrome://tracing``: one track per request plus engine/device tracks,
spans for queue wait / prefill chunks / decode steps, instants for
evictions, stalls, and COW copies.

Overhead contract: a disabled tracer is near-free.  ``span()`` returns
one shared no-op context-manager singleton (no per-call allocation) and
``complete``/``instant`` return before touching the event list — hot
call sites additionally guard on ``tracer.enabled`` so even the
timestamp reads and args dicts are skipped (asserted by the
disabled-fast-path test).

All spans are emitted as *complete* events (``ph: "X"`` — one record
carrying both start and duration), so begin/end matching holds by
construction; timestamps are microseconds relative to the tracer's
creation on one monotonic clock (``time.perf_counter``).
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional


class _NullSpan:
    """Shared no-op context manager for the disabled fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tr", "name", "tid", "cat", "args", "t0")

    def __init__(self, tr, name, tid, cat, args):
        self.tr, self.name, self.tid = tr, name, tid
        self.cat, self.args = cat, args

    def __enter__(self):
        self.t0 = self.tr.now()
        return self

    def __exit__(self, *exc):
        self.tr.complete(self.name, self.t0, self.tr.now(),
                         tid=self.tid, cat=self.cat, args=self.args)
        return False


class Tracer:
    """Append-only trace-event recorder on one monotonic clock.

    Track layout (``tid``): 0 = engine loop, 1 = device time, and one
    track per request via ``repro_torch.serve.telemetry.req_tid``.  ``pid`` is
    always 0 (single process).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.t0 = time.perf_counter()
        self.events: List[dict] = []
        self._threads: Dict[int, str] = {}

    # ---- clock -------------------------------------------------------------

    def now(self) -> float:
        """Seconds on the tracer's clock (``time.perf_counter``)."""
        return time.perf_counter()

    def _us(self, t_s: float) -> float:
        return (t_s - self.t0) * 1e6

    # ---- recording ---------------------------------------------------------

    def thread(self, tid: int, name: str) -> None:
        """Name a track (rendered as the thread name in Perfetto)."""
        if not self.enabled:
            return
        self._threads.setdefault(tid, name)

    def span(self, name: str, tid: int = 0, cat: str = "",
             args: Optional[dict] = None):
        """Context manager measuring a span; no-op singleton when
        disabled (zero allocation per call)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, tid, cat, args)

    def complete(self, name: str, t_start_s: float, t_end_s: float,
                 tid: int = 0, cat: str = "",
                 args: Optional[dict] = None) -> None:
        """One complete ('X') span from perf_counter seconds."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "X", "pid": 0, "tid": tid,
              "ts": self._us(t_start_s),
              "dur": max(0.0, (t_end_s - t_start_s) * 1e6)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, tid: int = 0, cat: str = "",
                args: Optional[dict] = None,
                t_s: Optional[float] = None) -> None:
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "pid": 0, "tid": tid, "s": "t",
              "ts": self._us(self.now() if t_s is None else t_s)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ---- export ------------------------------------------------------------

    def chrome_events(self) -> List[dict]:
        """Thread-name metadata + every recorded event (Chrome trace-event
        array form)."""
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": name}}
                for tid, name in sorted(self._threads.items())]
        return meta + list(self.events)

    def write_chrome(self, path: str) -> None:
        """JSON object form: ``{"traceEvents": [...]}`` — what Perfetto
        and chrome://tracing load directly."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(),
                       "displayTimeUnit": "ms"}, f, default=float)

    def write_jsonl(self, path: str) -> None:
        """One event object per line (stream-appendable form)."""
        with open(path, "w") as f:
            for ev in self.chrome_events():
                f.write(json.dumps(ev, default=float) + "\n")
