"""Device-profiler hook: an optional ``torch.profiler`` trace around
serving (port of ``repro/obs/profile.py``, which wraps ``jax.profiler``).

``profiler_trace(dir)`` runs ``torch.profiler`` with the CPU and (where a
card is present) CUDA activities while a serving run drains
(``launch/serve.py --profile-dir``), and writes its Chrome trace into
``dir``; it is a no-op for None.  The dump attributes time *inside* each
step, down to every kernel a CUDA-graph replay runs, complementing the
host-side ``time_device`` attribution the telemetry layer records per
engine step.

As in the reference, a profiler that fails to start or stop warns and
the serving run goes on unprofiled.
"""
from __future__ import annotations

import contextlib
import os
import warnings
from typing import Optional

TRACE_FILE = "torch_trace.json"


@contextlib.contextmanager
def profiler_trace(profile_dir: Optional[str] = None):
    """Context manager: ``torch.profiler`` trace written to
    ``profile_dir/torch_trace.json`` (no-op when None/empty).  Yields True
    iff the profiler actually started."""
    if not profile_dir:
        yield False
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(profile_dir, exist_ok=True)
        prof = profile(activities=acts)
        prof.start()
    except Exception as e:                      # platform-dependent
        warnings.warn(f"torch.profiler failed to start ({e}); serving "
                      "continues unprofiled")
        prof = None
    try:
        yield prof is not None
    finally:
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    # analysis: allow(host-sync): opt-in profile_dir,
                    # once at the trace's end
                    torch.cuda.synchronize()
                prof.stop()
                prof.export_chrome_trace(os.path.join(profile_dir,
                                                      TRACE_FILE))
            except Exception as e:              # platform-dependent
                warnings.warn(f"torch.profiler failed to stop or export "
                              f"({e})")
