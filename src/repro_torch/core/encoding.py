"""Encoding evaluation: truth-table B matrix, least-squares position
weights, RMSE (port of ``repro/core/encoding.py``; EncodingNet Eq. (1)).

The position-weight fit  s* = argmin Σ_t w_t (B_t s − v_t)²  is solved
with ridge-damped normal equations (duplicate gate outputs make B rank
deficient), in the reference's arithmetic: ``BᵀB·w``, ``Bᵀ(w·v)`` and
``Σ w v²`` accumulated in f32 over 8192-row chunks in the reference's
chunk order, ridge ``λ = 1e-6·(tr G / M + 1)``, an f32 solve, and
``rmse = sqrt(max(sᵀGs − 2sᵀc + Σw v², 0) / Σw)``.  The sums run in
another order than XLA's, so results agree within f32 rounding, not bit
for bit.

Circuits are fitted ``FIT_GROUP`` at a time, the last group padded with
copies, so every batched product and solve has one shape: a circuit's
RMSE then does not depend on its batch or its place in it, and a search
step that leaves a circuit's function unchanged reproduces its RMSE
exactly (the strict ``<`` of the search rejects it, as in the reference).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from . import gates as G
from .circuits import Circuit

FIT_GROUP = 16          # circuits per batched product and solve
FIT_CHUNK = 8192        # truth-table rows per accumulation step


@dataclasses.dataclass
class EncodingSpec:
    """An encoding: circuit + fitted position weights + fit quality."""
    circuit: Circuit
    s: np.ndarray                   # (M,) float32 position weights
    rmse: float
    values: Optional[np.ndarray] = None   # target products (T,) if given

    @property
    def m_bits(self) -> int:
        return self.circuit.m_bits

    def lut(self, s=None) -> torch.Tensor:
        """(2^bits_a, 2^bits_b) f32 approximate-product table ``B·s``,
        a-code-major, on the CPU."""
        s = self.s if s is None else s
        B = torch.from_numpy(truth_table_bits(self.circuit)).float()
        tbl = B @ torch.tensor(np.asarray(s, np.float32))
        return tbl.reshape(1 << self.circuit.bits_a,
                           1 << self.circuit.bits_b)


def truth_table_bits(circuit: Circuit) -> np.ndarray:
    """Full truth table of the circuit: (T, M) int8 bits,
    T = 2^(bits_a+bits_b)."""
    rows = _rows(circuit.bits_a, circuit.bits_b, torch.device("cpu"))
    return G.gate_bits_t(circuit.gate_types[None], circuit.in_idx[None],
                         rows)[0].t().numpy()


@functools.lru_cache(maxsize=8)
def _rows(bits_a: int, bits_b: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(G.operand_bit_table(bits_a, bits_b)).to(device)


@torch.inference_mode()
def fit_batch(gate_types: np.ndarray, in_idx: np.ndarray, values,
              row_weights, bits_a: int, bits_b: int,
              chunk: int = FIT_CHUNK, device=None):
    """Fit position weights for a batch of circuits (weighted least
    squares; port of the reference's ``_fit_batch``).

    gate_types (C, M), in_idx (C, M, 3), values (T,) and row_weights (T,)
    (all ones for the unweighted fit) → (s (C, M) f32, rmse (C,) f32), on
    ``device`` (default: the card)."""
    dev = resolve_device(device)
    gate_types = np.asarray(gate_types, np.int32)
    in_idx = np.asarray(in_idx, np.int32)
    C, M = gate_types.shape
    rows = _rows(bits_a, bits_b, dev)
    T = rows.shape[0]
    n_chunks = max(1, T // chunk)
    t = T // n_chunks
    vals = torch.as_tensor(np.asarray(values, np.float32)).to(dev)
    wts = torch.as_tensor(np.asarray(row_weights, np.float32)).to(dev)
    vv = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        v, w = vals[i * t:(i + 1) * t], wts[i * t:(i + 1) * t]
        vv = vv + torch.sum(w * v * v)
    w_sum = torch.sum(wts)
    eye = torch.eye(M, dtype=torch.float32, device=dev)
    s_out, rmse_out = [], []
    for g0 in range(0, C, FIT_GROUP):
        idx = np.minimum(np.arange(g0, g0 + FIT_GROUP), C - 1)
        gt, ii = gate_types[idx], in_idx[idx]
        Gm = torch.zeros((FIT_GROUP, M, M), dtype=torch.float32, device=dev)
        c = torch.zeros((FIT_GROUP, M, 1), dtype=torch.float32, device=dev)
        for i in range(n_chunks):
            sl = slice(i * t, (i + 1) * t)
            Bt = G.gate_bits_t(gt, ii, rows[sl], torch.float32)  # (g, M, t)
            Bw = Bt * wts[sl]
            Gm = Gm + torch.bmm(Bt, Bw.transpose(1, 2))
            c = c + torch.bmm(Bw, vals[sl].reshape(1, t, 1).expand(
                FIT_GROUP, t, 1))
        lam = 1e-6 * (torch.diagonal(Gm, dim1=1, dim2=2).sum(-1) / M + 1.0)
        s = torch.linalg.solve(Gm + lam[:, None, None] * eye, c)  # (g, M, 1)
        st = s.transpose(1, 2)
        # Σw‖Bs−v‖² = sᵀGs − 2sᵀc + Σw v²  (no need to re-stream B)
        sse = torch.clamp_min(torch.bmm(torch.bmm(st, Gm), s)
                              - torch.bmm(2.0 * st, c) + vv, 0.0)
        n = min(FIT_GROUP, C - g0)
        s_out.append(s[:n, :, 0])
        rmse_out.append(torch.sqrt(sse[:n, 0, 0] / w_sum))
    return torch.cat(s_out), torch.cat(rmse_out)


def fit_position_weights(gate_types: np.ndarray, in_idx: np.ndarray,
                         values: np.ndarray, bits_a: int = 8,
                         bits_b: int = 8,
                         row_weights: Optional[np.ndarray] = None,
                         device=None) -> tuple[np.ndarray, np.ndarray]:
    """Batched (weighted) least-squares fit on ``device`` (default: the
    card) → (s (C, M), rmse (C,)) as numpy f32.

    ``row_weights`` (T,) weights each truth-table row; None ⇒ uniform (the
    paper's fit).  Weighted RMSE normalizes by Σw."""
    T = 1 << (bits_a + bits_b)
    w = (np.ones((T,), np.float32) if row_weights is None
         else np.asarray(row_weights, np.float32))
    s, rmse = fit_batch(gate_types, in_idx, values, w, bits_a, bits_b,
                        chunk=min(FIT_CHUNK, T), device=device)
    return s.cpu().numpy(), rmse.cpu().numpy()


def fit_circuit(circuit: Circuit, values: Optional[np.ndarray] = None,
                device=None) -> EncodingSpec:
    """Fit a single circuit."""
    if values is None:
        values = G.signed_products(circuit.bits_a, circuit.bits_b)
    s, rmse = fit_position_weights(circuit.gate_types[None],
                                   circuit.in_idx[None], values,
                                   circuit.bits_a, circuit.bits_b,
                                   device=device)
    return EncodingSpec(circuit, s[0], float(rmse[0]),
                        values=np.asarray(values, np.float32))


def rmse_of(circuit: Circuit, s: np.ndarray,
            values: Optional[np.ndarray] = None,
            row_weights: Optional[np.ndarray] = None) -> float:
    """Direct RMSE evaluation on the host (independent of the
    normal-equation path)."""
    if values is None:
        values = G.signed_products(circuit.bits_a, circuit.bits_b)
    B = truth_table_bits(circuit).astype(np.float32)
    err = B @ np.asarray(s, np.float32) - np.asarray(values, np.float32)
    if row_weights is None:
        return float(np.sqrt(np.mean(err ** 2)))
    w = np.asarray(row_weights, np.float64)
    return float(np.sqrt(np.sum(w * err.astype(np.float64) ** 2) / w.sum()))
