"""The encoding record (port of ``EncodingSpec`` from
``repro/core/encoding.py``).  The least-squares fit and the search wait
(ROADMAP: paper side)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .circuits import Circuit


@dataclasses.dataclass
class EncodingSpec:
    """An encoding: circuit + fitted position weights + fit quality."""
    circuit: Circuit
    s: np.ndarray                   # (M,) float32 position weights
    rmse: float
    values: Optional[np.ndarray] = None

    @property
    def m_bits(self) -> int:
        return self.circuit.m_bits
