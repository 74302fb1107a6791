"""Computation-environment knobs for the port's launchers (the
counterpart of ``repro/launch/env.py``; its JAX platform and precision
switches have no counterpart in the port).
"""
from __future__ import annotations

from repro_torch.core import macexec


def set_debug_nan(flag: bool) -> None:
    """Raise ``FloatingPointError`` on the first non-finite output of any
    linear (named in the message) or of the logits, as the reference's
    ``jax_debug_nans`` raises at the first NaN.  While the flag is on the
    engines run their steps eagerly (a CUDA-graph replay cannot stop at an
    op), and every check waits for the card.  Debug-only: never leave it on
    in a benchmark run."""
    macexec.set_debug_nan(flag)
