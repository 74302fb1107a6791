"""Single-level gate library for encoding-based multipliers (port of
``repro/core/gates.py``).  The tables are host-side numpy metadata; the
batched evaluation the least-squares fit streams (``eval_gates_batch``)
runs in torch on any device.

Operand bits are indexed ``0..bits_a-1`` (LSB..MSB of operand A, two's
complement) followed by ``bits_a..bits_a+bits_b-1`` (operand B).
"""
from __future__ import annotations

import numpy as np
import torch

# Gate type ids (stable — serialized in circuit artifacts).
SET, IN, NOT, AND2, OR2, NAND2, NAND3, XOR3 = range(8)

GATE_NAMES = ["SET", "IN", "NOT", "AND2", "OR2", "NAND2", "NAND3", "XOR3"]
N_GATE_TYPES = 8

# Number of distinct operand-bit inputs each gate consumes.
GATE_ARITY = np.array([0, 1, 1, 2, 2, 2, 3, 3], dtype=np.int32)

# Gate-equivalent area/power proxies (relative to NAND2 == 1.0); SET/IN
# are wires (0 cost).
GATE_AREA_GE = np.array([0.0, 0.0, 0.67, 1.33, 1.33, 1.0, 1.33, 3.0])


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


def _truth_bytes() -> np.ndarray:
    """(N_GATE_TYPES,) truth table of every gate as one byte: bit
    ``x0 + 2·x1 + 4·x2`` is the gate's output on those inputs."""
    rows = np.asarray([[(j >> b) & 1 for b in range(3)] for j in range(8)])
    out = eval_gates(np.arange(N_GATE_TYPES),
                     np.tile(np.arange(3), (N_GATE_TYPES, 1)), rows)
    return (out.astype(np.int64) << np.arange(8)[:, None]).sum(0)


GATE_TRUTH = _truth_bytes()


def gate_bits_t(gate_types, in_idx, rows: torch.Tensor,
                dtype=torch.int8) -> torch.Tensor:
    """Transposed batched gate outputs: (C, M) gate types, (C, M, 3) input
    indices and (t, n_in) operand-bit rows (torch, on the device to
    compute on) → (C, M, t) 0/1 in ``dtype``.  A table lookup: each gate's
    truth byte shifted by its 3-bit input pattern."""
    dev = rows.device
    C, M = np.shape(gate_types)
    gt = torch.as_tensor(np.asarray(gate_types), device=dev).long()
    ii = torch.as_tensor(np.asarray(in_idx), device=dev).long()
    r = rows.to(torch.uint8).t().contiguous()                # (n_in, t)
    sel = torch.index_select(r, 0, ii[..., 0].reshape(-1))
    sel |= torch.index_select(r << 1, 0, ii[..., 1].reshape(-1))
    sel |= torch.index_select(r << 2, 0, ii[..., 2].reshape(-1))
    truth = torch.as_tensor(GATE_TRUTH, device=dev).to(torch.uint8)[gt]
    return ((truth.reshape(-1, 1) >> sel) & 1).view(C, M, -1).to(dtype)


def eval_gates_batch(gate_types, in_idx, rows) -> torch.Tensor:
    """Batched ``eval_gates``: (C, M) gate types, (C, M, 3) input indices,
    (t, n_in) operand bits (a torch tensor on any device, or numpy on the
    CPU) → (C, t, M) int8 output bits on the rows' device."""
    return gate_bits_t(gate_types, in_idx, torch.as_tensor(rows)
                       ).transpose(1, 2)


def int_to_bits(values: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Two's-complement bits (LSB first) of integer values:
    (…,) → (…, n_bits) int8."""
    v = torch.as_tensor(values).to(torch.int32) & ((1 << n_bits) - 1)
    shifts = torch.arange(n_bits, dtype=torch.int32, device=v.device)
    return ((v[..., None] >> shifts) & 1).to(torch.int8)


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


def level_products(levels_a: np.ndarray, levels_b: np.ndarray) -> np.ndarray:
    """Products of arbitrary (non-uniform) quantization levels, in
    truth-table row order (the Fig 7 path)."""
    return (np.asarray(levels_a, np.float32)[:, None]
            * np.asarray(levels_b, np.float32)[None, :]).reshape(-1)
