"""Observability primitives of the port (port of ``repro/obs``): metrics
registry, trace-event recorder, shared order statistics, CUDA-graph
capture tracker, drift monitor, profiler hook.

Serving-specific wiring (track ids, the telemetry bundle) lives in
``repro_torch.serve.telemetry``; this package does not import the serving
stack, so tools can use it standalone.
"""
from .stats import percentile, percentiles
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      DEFAULT_BUCKETS)
from .trace import Tracer, NULL_SPAN
from .jitcount import CompileTracker
from .drift import DriftMonitor, logit_agreement
from .profile import profiler_trace
