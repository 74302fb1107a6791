"""Circuit specification and random sampling (port of
``repro/core/circuits.py``).  A circuit is M single-level gates; gate j
drives output bit j.  Plain numpy metadata."""
from __future__ import annotations

import dataclasses

import numpy as np

from . import gates as G


@dataclasses.dataclass
class Circuit:
    """Static description of an encoding-based multiplier circuit."""
    gate_types: np.ndarray          # (M,) int32
    in_idx: np.ndarray              # (M, 3) int32 — operand-bit inputs
    bits_a: int = 8
    bits_b: int = 8

    @property
    def m_bits(self) -> int:
        return int(self.gate_types.shape[0])


def sample_circuits(rng: np.random.Generator, n: int, m_bits: int,
                    bits_a: int = 8, bits_b: int = 8,
                    mixed_only: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Sample ``n`` random circuits → (gate_types (n, M), in_idx (n, M, 3)).

    ``mixed_only`` forces multi-input gates to draw input 0 from A and
    input 1 from B (the paper samples uniformly — keep False)."""
    n_in = bits_a + bits_b
    gate_types = rng.integers(0, G.N_GATE_TYPES, size=(n, m_bits),
                              dtype=np.int32)
    in_idx = rng.integers(0, n_in, size=(n, m_bits, 3), dtype=np.int32)
    if mixed_only:
        multi = G.GATE_ARITY[gate_types] >= 2
        a_pick = rng.integers(0, bits_a, size=(n, m_bits), dtype=np.int32)
        b_pick = rng.integers(0, bits_b, size=(n, m_bits),
                              dtype=np.int32) + bits_a
        in_idx[:, :, 0] = np.where(multi, a_pick, in_idx[:, :, 0])
        in_idx[:, :, 1] = np.where(multi, b_pick, in_idx[:, :, 1])
    return gate_types, in_idx


def exact_product_circuit(bits_a: int = 4, bits_b: int = 4
                          ) -> tuple[Circuit, np.ndarray]:
    """Exact signed-multiplier encoding: one AND2 gate per (a_i, b_j) pair
    with position weight w_i·w_j, w_i = ±2^i (two's complement).  RMSE 0,
    M = bits_a·bits_b; decomposes to bits_a single-bit activation planes."""
    wa = [float(1 << i) for i in range(bits_a)]
    wa[-1] = -wa[-1]
    wb = [float(1 << j) for j in range(bits_b)]
    wb[-1] = -wb[-1]
    gate_types, in_idx, s = [], [], []
    for i in range(bits_a):
        for j in range(bits_b):
            gate_types.append(G.AND2)
            in_idx.append([i, bits_a + j, i])       # 3rd slot unused by AND2
            s.append(wa[i] * wb[j])
    return (Circuit(np.asarray(gate_types, np.int32),
                    np.asarray(in_idx, np.int32), bits_a, bits_b),
            np.asarray(s, np.float32))
