"""Circuit specification and random sampling (port of
``repro/core/circuits.py``).  A circuit is M single-level gates; gate j
drives output bit j.  Plain numpy metadata; its JSON is the reference's,
so either package reads the other's files."""
from __future__ import annotations

import dataclasses
import json

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

    @property
    def n_inputs(self) -> int:
        return self.bits_a + self.bits_b

    def validate(self) -> None:
        """Raise ValueError unless the arrays have the circuit's shapes and
        every gate type and input index is in range."""
        M = self.m_bits
        if self.gate_types.shape != (M,) or self.in_idx.shape != (M, 3):
            raise ValueError(f"circuit arrays {self.gate_types.shape}, "
                             f"{self.in_idx.shape}: expected ({M},), "
                             f"({M}, 3)")
        if M and (self.gate_types.min() < 0
                  or self.gate_types.max() >= G.N_GATE_TYPES):
            raise ValueError("gate type out of range")
        if M and (self.in_idx.min() < 0
                  or self.in_idx.max() >= self.n_inputs):
            raise ValueError("gate input index out of range")

    def gate_equivalents(self) -> float:
        """Hardware cost in gate equivalents (NAND2 = 1)."""
        return float(G.GATE_AREA_GE[self.gate_types].sum())

    def to_json(self) -> str:
        return json.dumps({
            "gate_types": self.gate_types.tolist(),
            "in_idx": self.in_idx.tolist(),
            "bits_a": self.bits_a,
            "bits_b": self.bits_b,
        })

    @staticmethod
    def from_json(s: str) -> "Circuit":
        d = json.loads(s)
        return Circuit(np.asarray(d["gate_types"], np.int32),
                       np.asarray(d["in_idx"], np.int32),
                       d["bits_a"], d["bits_b"])


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


def circuit_from_batch(gate_types: np.ndarray, in_idx: np.ndarray, i: int,
                       bits_a: int = 8, bits_b: int = 8) -> Circuit:
    """Circuit ``i`` of a sampled batch."""
    return Circuit(np.asarray(gate_types[i], np.int32),
                   np.asarray(in_idx[i], np.int32), bits_a, bits_b)


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


def paper_fig2_circuit() -> tuple[Circuit, np.ndarray]:
    """The 2-bit example of Fig. 2(c): a hand-built 5-bit encoding of a
    2-bit signed multiplier, (circuit, position weights).  The paper does
    not publish its wiring; this is the reference's frozen stand-in."""
    # inputs: 0=a0, 1=a1(sign), 2=b0, 3=b1(sign)
    gate_types = np.array([G.AND2, G.AND2, G.AND2, G.AND2, G.XOR3], np.int32)
    in_idx = np.array([
        [0, 2, 0],   # a0 & b0
        [0, 3, 0],   # a0 & b1
        [1, 2, 0],   # a1 & b0
        [1, 3, 0],   # a1 & b1
        [1, 3, 1],   # a1 ^ b1 ^ a1 = b1 (a wire; keeps 5 bits)
    ], np.int32)
    s = np.array([1.0, -2.0, -2.0, 4.0, 0.0], np.float32)
    return Circuit(gate_types, in_idx, 2, 2), s
