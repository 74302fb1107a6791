"""Single-level gate library for encoding-based multipliers (port of
``repro/core/gates.py``; host-side numpy metadata).

Operand bits are indexed ``0..bits_a-1`` (LSB..MSB of operand A, two's
complement) followed by ``bits_a..bits_a+bits_b-1`` (operand B).
"""
from __future__ import annotations

import numpy as np

# Gate type ids (stable — serialized in circuit artifacts).
SET, IN, NOT, AND2, OR2, NAND2, NAND3, XOR3 = range(8)

N_GATE_TYPES = 8

# Number of distinct operand-bit inputs each gate consumes.
GATE_ARITY = np.array([0, 1, 1, 2, 2, 2, 3, 3], dtype=np.int32)


def eval_gates(gate_types: np.ndarray, in_idx: np.ndarray,
               bits: np.ndarray) -> np.ndarray:
    """(M,) gate types, (M, 3) input indices, (T, n_bits) operand bits →
    (T, M) int8 output bits."""
    bits = np.asarray(bits, np.int32)
    x0 = bits[:, in_idx[:, 0]]
    x1 = bits[:, in_idx[:, 1]]
    x2 = bits[:, in_idx[:, 2]]
    outs = np.stack([
        np.ones_like(x0), x0, 1 - x0, x0 * x1, x0 + x1 - x0 * x1,
        1 - x0 * x1, 1 - x0 * x1 * x2, (x0 ^ x1) ^ x2,
    ], axis=0)                                   # (8, T, M)
    sel = np.take_along_axis(
        outs, np.asarray(gate_types, np.int64)[None, None, :], axis=0)[0]
    return sel.astype(np.int8)


def operand_bit_table(bits_a: int, bits_b: int) -> np.ndarray:
    """All (2^bits_a * 2^bits_b) operand-bit rows, A-bits then B-bits,
    a-code-major over raw (unsigned) bit patterns."""
    ta, tb = 1 << bits_a, 1 << bits_b
    a_codes = np.repeat(np.arange(ta), tb)
    b_codes = np.tile(np.arange(tb), ta)
    rows = np.zeros((ta * tb, bits_a + bits_b), dtype=np.int8)
    for i in range(bits_a):
        rows[:, i] = (a_codes >> i) & 1
    for i in range(bits_b):
        rows[:, bits_a + i] = (b_codes >> i) & 1
    return rows


def signed_products(bits_a: int, bits_b: int) -> np.ndarray:
    """Exact signed products for every truth-table row (same row order)."""
    ta, tb = 1 << bits_a, 1 << bits_b
    a = np.arange(ta)
    a = np.where(a >= ta // 2, a - ta, a)
    b = np.arange(tb)
    b = np.where(b >= tb // 2, b - tb, b)
    return (a[:, None] * b[None, :]).reshape(-1).astype(np.float32)
