"""Bitplane decomposition of an encoding circuit (port of
``repro/core/decompose.py``).

Every single-level gate output is a multilinear polynomial over operand
bits; each monomial factors into (activation bits) × (weight bits), so the
encoded MAC over an (m,k)×(k,n) product becomes

    out = Σ_u  A_u(x) @ W̃_u(s, w)  + bias(s, w)

with ``A_u ∈ {0,1}^{m×k}`` computed by shift/AND on int8 codes and
``W̃_u`` folded offline from the circuit, the weight bit-planes and the
position weights ``s``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.kernels.ref import planes_ref
from . import gates as G
from .circuits import Circuit

Poly = dict       # frozenset[int] (operand-bit monomial) -> float


def _pmul(p: Poly, q: Poly) -> Poly:
    out: Poly = {}
    for ma, ca in p.items():
        for mb, cb in q.items():
            m = ma | mb                      # idempotent: b*b = b
            out[m] = out.get(m, 0.0) + ca * cb
    return {m: c for m, c in out.items() if c != 0.0}


def _padd(p: Poly, q: Poly, alpha: float = 1.0) -> Poly:
    out = dict(p)
    for m, c in q.items():
        out[m] = out.get(m, 0.0) + alpha * c
    return {m: c for m, c in out.items() if c != 0.0}


def _bit(i: int) -> Poly:
    return {frozenset({int(i)}): 1.0}


_ONE: Poly = {frozenset(): 1.0}


def gate_polynomial(gate_type: int, idx: np.ndarray) -> Poly:
    x0, x1, x2 = _bit(idx[0]), _bit(idx[1]), _bit(idx[2])
    if gate_type == G.SET:
        return dict(_ONE)
    if gate_type == G.IN:
        return x0
    if gate_type == G.NOT:
        return _padd(_ONE, x0, -1.0)
    if gate_type == G.AND2:
        return _pmul(x0, x1)
    if gate_type == G.OR2:
        return _padd(_padd(x0, x1), _pmul(x0, x1), -1.0)
    if gate_type == G.NAND2:
        return _padd(_ONE, _pmul(x0, x1), -1.0)
    if gate_type == G.NAND3:
        return _padd(_ONE, _pmul(_pmul(x0, x1), x2), -1.0)
    if gate_type == G.XOR3:
        def xor(p, q):
            return _padd(_padd(p, q), _pmul(p, q), -2.0)
        return xor(xor(x0, x1), x2)
    raise ValueError(f"unknown gate type {gate_type}")


@dataclasses.dataclass
class BitplaneProgram:
    """Static decomposition of a circuit into bilinear/rank-1/constant
    terms.  Term p couples activation monomial ``a_of[p]`` (-1 = empty)
    with weight monomial ``b_of[p]`` (-1 = empty); its coefficient is
    ``coeff_map[p] @ s``.  Monomial bit lists are padded to length 3 by
    repeating the last bit (AND-idempotent)."""
    bits_a: int
    bits_b: int
    m_bits: int
    a_mono_bits: np.ndarray      # (U, 3) int32 — shift amounts into x codes
    b_mono_bits: np.ndarray      # (V, 3) int32 — shift amounts into w codes
    coeff_map: np.ndarray        # (P, M) float32
    a_of: np.ndarray             # (P,) int32 in [-1, U)
    b_of: np.ndarray             # (P,) int32 in [-1, V)

    @property
    def n_a_planes(self) -> int:
        return int(self.a_mono_bits.shape[0])

    @property
    def n_b_planes(self) -> int:
        return int(self.b_mono_bits.shape[0])

    @functools.cached_property
    def a_mono_tuples(self) -> tuple:
        """Activation monomials as variable-arity tuples (1–3 distinct
        bits), the padding stripped (computed once: every encoded linear
        call reads it)."""
        return tuple(tuple(dict.fromkeys(int(b) for b in row))
                     for row in self.a_mono_bits)

    def scatter_coeffs(self, s: torch.Tensor):
        """Coefficient tensors from s (on s's device, f32):
        (S_bil (U,V), S_a (U,), S_b (V,), c0)."""
        s = s.to(torch.float32)
        dev = s.device
        c = torch.as_tensor(self.coeff_map, device=dev) @ s      # (P,)
        U, V = self.n_a_planes, self.n_b_planes
        a_of = torch.as_tensor(self.a_of, device=dev).long()
        b_of = torch.as_tensor(self.b_of, device=dev).long()
        bil = (a_of >= 0) & (b_of >= 0)
        aon = (a_of >= 0) & (b_of < 0)
        bon = (a_of < 0) & (b_of >= 0)
        con = (a_of < 0) & (b_of < 0)
        S_bil = torch.zeros((U, V), dtype=torch.float32, device=dev)
        S_bil.index_put_((a_of[bil], b_of[bil]), c[bil], accumulate=True)
        S_a = torch.zeros((U,), dtype=torch.float32, device=dev)
        S_a.index_put_((a_of[aon],), c[aon], accumulate=True)
        S_b = torch.zeros((V,), dtype=torch.float32, device=dev)
        S_b.index_put_((b_of[bon],), c[bon], accumulate=True)
        c0 = c[con].sum()
        return S_bil, S_a, S_b, c0

    def planes(self, codes: torch.Tensor, side: str) -> torch.Tensor:
        """Monomial bit-planes of int codes: (…,) → (U|V, …) int8 {0,1}."""
        return planes_ref(codes, self.a_mono_bits if side == "a"
                          else self.b_mono_bits)

    def fold_weights(self, w_codes: torch.Tensor, s: torch.Tensor):
        """Fold circuit + s + weight planes → (W̃ (U,k,n) f32, bias (n,)
        f32), on ``w_codes``' device."""
        k = w_codes.shape[0]
        S_bil, S_a, S_b, c0 = self.scatter_coeffs(s.to(w_codes.device))
        Gv = self.planes(w_codes, "b").to(torch.float32)         # (V, k, n)
        Wt = torch.einsum("uv,vkn->ukn", S_bil, Gv) + S_a[:, None, None]
        bias = torch.einsum("v,vn->n", S_b, Gv.sum(dim=1)) + c0 * k
        return Wt, bias


def decompose(circuit: Circuit) -> BitplaneProgram:
    """Expand a circuit into a BitplaneProgram (static, numpy)."""
    ba = circuit.bits_a
    term_coeffs: dict[tuple, np.ndarray] = {}
    M = circuit.m_bits
    for j in range(M):
        poly = gate_polynomial(int(circuit.gate_types[j]), circuit.in_idx[j])
        for mono, coef in poly.items():
            ma = tuple(sorted(i for i in mono if i < ba))
            mb = tuple(sorted(i - ba for i in mono if i >= ba))
            key = (ma, mb)
            if key not in term_coeffs:
                term_coeffs[key] = np.zeros((M,), np.float32)
            term_coeffs[key][j] += coef

    a_monos = sorted({k[0] for k in term_coeffs if k[0]})
    b_monos = sorted({k[1] for k in term_coeffs if k[1]})
    a_index = {m: i for i, m in enumerate(a_monos)}
    b_index = {m: i for i, m in enumerate(b_monos)}

    def pad3(mono: tuple) -> list[int]:
        out = list(mono)
        while len(out) < 3:
            out.append(out[-1] if out else 0)
        return out

    a_bits = np.asarray([pad3(m) for m in a_monos] or
                        np.zeros((0, 3)), np.int32).reshape(-1, 3)
    b_bits = np.asarray([pad3(m) for m in b_monos] or
                        np.zeros((0, 3)), np.int32).reshape(-1, 3)

    keys = sorted(term_coeffs.keys())
    coeff = np.stack([term_coeffs[k] for k in keys]) if keys else \
        np.zeros((0, M), np.float32)
    a_of = np.asarray([a_index.get(k[0], -1) if k[0] else -1 for k in keys],
                      np.int32)
    b_of = np.asarray([b_index.get(k[1], -1) if k[1] else -1 for k in keys],
                      np.int32)
    return BitplaneProgram(circuit.bits_a, circuit.bits_b, M,
                           a_bits, b_bits, coeff.astype(np.float32),
                           a_of, b_of)
