"""LR schedules (port of ``repro/optim/schedule.py``), evaluated on the
host in f32 with the operations of the reference's compiled train step in
their order, so every step's rate equals the reference's bit for bit.

Three things make that order: XLA rewrites a division by a constant as
a product with the constant's f32 reciprocal, contracts a product
followed by a sum into one fused multiply-add (one rounding), and on the
CPU computes the cosine with the C library's ``cosf``, which the port
calls too.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from fractions import Fraction

import numpy as np

_f32 = np.float32


@functools.cache
def _libm_cosf():
    name = ctypes.util.find_library("m")
    if name is None:
        return None
    fn = ctypes.CDLL(name).cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def cos_f32(x) -> np.float32:
    """cos of an f32 value, rounded to f32 (``cosf``; the f64 cosine
    rounded to f32 where the C library has none)."""
    fn = _libm_cosf()
    if fn is None:
        return _f32(math.cos(float(x)))
    return _f32(fn(float(x)))


def fma_f32(a, b, c) -> np.float32:
    """``a * b + c`` rounded once to f32 (round half to even), as a fused
    multiply-add gives it."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = _f32(float(exact))           # at most one f32 step from the answer
    cands = (np.nextafter(r, _f32(-np.inf)), r,
             np.nextafter(r, _f32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(v.view(np.uint32)) & 1))


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1):
    """``lr(step)`` → np.float32: linear warm-up to ``base_lr`` over
    ``warmup`` steps, then a cosine decay to ``min_frac * base_lr`` at
    ``total``.  ``step`` is an int or a 0-d tensor/array."""
    lr0 = _f32(base_lr)
    inv_w = _f32(1.0) / _f32(max(warmup, 1))
    inv_span = _f32(1.0) / _f32(max(total - warmup, 1))
    half = _f32((1 - min_frac) * 0.5)

    def lr(step):
        s = _f32(int(step))
        if s < _f32(warmup):
            return lr0 * min(_f32(1.0), s * inv_w)
        prog = min(max((s - _f32(warmup)) * inv_span, _f32(0.0)),
                   _f32(1.0))
        c = cos_f32(_f32(np.pi) * prog)
        return lr0 * fma_f32(_f32(1.0) + c, half, _f32(min_frac))
    return lr
