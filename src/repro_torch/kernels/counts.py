"""The kernels' launch counters, in one registry.

Each wrapper that launches a hand-written kernel registers itself here
(``register``) and adds one to its counters where it launches.  Whatever
reads or carries the counters (a captured CUDA graph in
``serve/graphs.py``, ``chip_smoke.py``) goes through the functions below,
so a counter a wrapper registers later is read, set and carried with the
others.
"""
from __future__ import annotations

import collections

# key → (wrapper, attribute): the wrapper's total launches (an int) or its
# launches by shape (a Counter)
_COUNTERS: dict = {}


def register(fn, **by_shape):
    """Give the kernel wrapper ``fn`` its counter ``fn.launches`` (key:
    the wrapper's name) and, for each ``key=attr``, a Counter of its
    launches by shape ``fn.<attr>`` (key: ``key``).  Returns ``fn``."""
    fn.launches = 0
    _COUNTERS[fn.__name__] = (fn, "launches")
    for key, attr in by_shape.items():
        setattr(fn, attr, collections.Counter())
        _COUNTERS[key] = (fn, attr)
    return fn


def _is_shape(v) -> bool:
    return isinstance(v, collections.Counter)


def launch_counts() -> dict:
    """Every registered counter by key (by-shape ones as copies)."""
    out = {}
    for key, (fn, attr) in _COUNTERS.items():
        v = getattr(fn, attr)
        out[key] = collections.Counter(v) if _is_shape(v) else v
    return out


def set_launch_counts(counts: dict) -> None:
    """Set every counter to ``counts`` (a missing key sets 0, or empties a
    by-shape counter), e.g. ``{}`` before a counted run."""
    for key, (fn, attr) in _COUNTERS.items():
        v = getattr(fn, attr)
        if _is_shape(v):
            v.clear()
            v.update(counts.get(key, {}))
        else:
            setattr(fn, attr, counts.get(key, 0))


def diff_counts(after: dict, before: dict) -> dict:
    """``after - before`` for two ``launch_counts()`` (by-shape counters
    keep their positive entries; a counter registered between the two
    counts from zero)."""
    out = {}
    for key in _COUNTERS:
        a = after[key]
        b = before.get(key, collections.Counter() if _is_shape(a) else 0)
        if _is_shape(a):
            c = collections.Counter(a)
            c.subtract(b)
            out[key] = +c
        else:
            out[key] = a - b
    return out


def add_counts(delta: dict) -> None:
    """Add a ``diff_counts`` result to every counter (one registered
    since adds nothing)."""
    for key, (fn, attr) in _COUNTERS.items():
        v = getattr(fn, attr)
        if _is_shape(v):
            v.update(delta.get(key, {}))
        else:
            setattr(fn, attr, v + delta.get(key, 0))
