"""CUDA-graph capture tracker: the port's counterpart of the reference's
``CompileTracker`` (``repro/obs/jitcount.py``), which counts XLA compiles
per named jitted step.

The port's engine runs each serving step as one captured CUDA graph
(``repro_torch.serve.graphs.Step``); a step that had to capture again
would show a leaked shape or a lost graph.  ``CompileTracker`` snapshots
each tracked step's ``captures`` at attach time and reports the delta, so
an engine exports exactly how many captures *it* caused.

The engine feeds the deltas into the ``jit_compiles`` labeled counter
(``fn=prefill|decode|draft|verify|copy_page``).  The port's ``copy_page``
is an eager in-place copy (``PagedKVCache.copy_page``), not a captured
step, so nothing is tracked under ``copy_page`` and its label stays 0.
On the CPU, and with ``cuda_graphs=False``, no step captures: every
count is 0.
"""
from __future__ import annotations

from typing import Dict


class CompileTracker:
    """Per-name capture deltas over the engine's steps.

    ``track(name, step)`` registers ``step`` (anything with a
    ``captures`` count; others are ignored) and returns it unchanged.
    ``counts()`` maps name → captures since attach; ``publish(counter)``
    increments a labeled obs counter by the delta since the last publish
    (idempotent between captures)."""

    def __init__(self) -> None:
        self._steps: Dict[str, object] = {}
        self._base: Dict[str, int] = {}
        self._published: Dict[str, int] = {}

    def track(self, name: str, step):
        if step is not None and hasattr(step, "captures"):
            self._steps[name] = step
            self._base[name] = int(step.captures)
            self._published.setdefault(name, 0)
        return step

    def counts(self) -> Dict[str, int]:
        return {n: int(s.captures) - self._base[n]
                for n, s in self._steps.items()}

    def total(self) -> int:
        return sum(self.counts().values())

    def publish(self, counter) -> int:
        """Sync a ``repro_torch.obs`` Counter (labeled ``fn=``) to the
        current counts; returns the total."""
        c = self.counts()
        for name, v in c.items():
            d = v - self._published.get(name, 0)
            if d > 0:
                counter.inc(d, fn=name)
                self._published[name] = v
        return sum(c.values())
