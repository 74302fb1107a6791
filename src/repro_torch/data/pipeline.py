"""Host data pipeline: background prefetch and straggler skip-batch hook
(port of ``repro/data/pipeline.py``, plain Python).

Determinism is keyed by step, so any run can recompute any step (a
resume replays the stream).  The prefetch thread hides host-side batch
generation behind device compute; ``skip_threshold`` is straggler
mitigation — if a batch is not ready within the timeout the step is
skipped and logged rather than stalling the trainer.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class DataPipeline:
    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0,
                 prefetch: int = 2, skip_threshold: Optional[float] = None):
        self.make_batch = make_batch
        self.q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self.step = start_step
        self.skip_threshold = skip_threshold
        self.skipped: list[int] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        s = self.step
        while not self._stop.is_set():
            try:
                b = self.make_batch(s)
            except Exception:          # pragma: no cover - defensive
                break
            while not self._stop.is_set():
                try:
                    self.q.put((s, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self) -> tuple[int, dict]:
        """Next (step, batch); skips a step if the straggler timeout
        trips."""
        if self.skip_threshold is None:
            return self.q.get()
        try:
            return self.q.get(timeout=self.skip_threshold)
        except queue.Empty:
            self.skipped.append(self.step)
            self.step += 1
            return self.q.get()        # block for the following one

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
