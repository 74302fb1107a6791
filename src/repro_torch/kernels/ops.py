"""Public entry for the encoded matmul (port of ``repro/kernels/ops.py``:
monomial normalisation and dispatch).  The kernel masks ragged m/k/n
itself, so nothing is padded here."""
from __future__ import annotations

import functools

import numpy as np

from . import encoded_matmul as _em


def _norm_monos(mono_bits) -> tuple:
    """Normalize monomials to variable-arity tuples of distinct shifts.

    Accepts the padded ``(U, 3)`` array form or sequences of 1–3 bit
    positions; order within a monomial is preserved."""
    out = []
    for row in mono_bits:
        shifts = tuple(dict.fromkeys(int(b) for b in np.atleast_1d(row)))
        if not 1 <= len(shifts) <= 3:
            raise ValueError(f"monomial needs 1–3 distinct bits, got {row!r}")
        out.append(shifts)
    return tuple(out)


def _pad3(monos: tuple) -> np.ndarray:
    """(U, 3) int32 padded form (repeat the last bit)."""
    return np.asarray([(m + (m[-1],) * 3)[:3] for m in monos], np.int32
                      ).reshape(-1, 3)


def encoded_matmul(x_codes, wt, bias, mono_bits):
    """x_codes (m,k) int8 · wt (U,k,n) · bias (n,) → (m,n) f32.

    ``mono_bits``: (U, 3) padded array or sequence of 1–3-bit monomial
    tuples.  CPU tensors run the plain version, CUDA tensors the kernel
    (``kernels.encoded_matmul.encoded_matmul``)."""
    if isinstance(mono_bits, tuple):
        shifts = _shift_table(mono_bits)
    else:
        shifts = _pad3(_norm_monos(mono_bits))
    return _em.encoded_matmul(x_codes, wt, bias, shifts)


@functools.lru_cache(maxsize=64)
def _shift_table(monos: tuple) -> np.ndarray:
    """Padded (U, 3) shifts of a monomial tuple, built once per encoding
    (the serving path passes the same few tuples on every call)."""
    table = _pad3(_norm_monos(monos))
    table.flags.writeable = False
    return table
