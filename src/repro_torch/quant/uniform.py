"""Uniform symmetric quantization with STE (port of
``repro/quant/uniform.py``).

Codes are signed integers in [-(2^{b-1}-1), 2^{b-1}-1]; rounding is
round-half-even (``torch.round``) on the f32 quotient ``x / scale`` —
never ``x * (1 / scale)``, which rounds differently at .5 boundaries."""
from __future__ import annotations

import numpy as np
import torch


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def calibrate_scale(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Symmetric per-tensor scale from max-abs: ``max(amax, 1e-8) / qmax``
    as a 0-d f32 tensor on ``x``'s device."""
    amax = x.detach().abs().amax().float()
    return torch.clamp_min(amax, 1e-8) / qmax(bits)


def quantize_codes(x: torch.Tensor, scale, bits: int = 8) -> torch.Tensor:
    """Float → int8 codes, symmetric round-half-even."""
    m = qmax(bits)
    return torch.clamp(torch.round(x / scale), -m, m).to(torch.int8)


def dequantize(codes: torch.Tensor, scale) -> torch.Tensor:
    return codes.to(torch.float32) * scale


class _SteRound(torch.autograd.Function):
    """round-half-even forward, identity backward (the reference's
    ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return _SteRound.apply(x)


def fake_quant(x: torch.Tensor, scale, bits: int = 8) -> torch.Tensor:
    """Quantize-dequantize with straight-through gradients (QAT).

    The clip is ``minimum(maximum(q, -m), m)``, as ``jnp.clip`` computes
    it: at a value exactly on a bound both ops pass half the gradient, so
    the clip passes 0.5 there (``torch.clamp`` would pass 1).  The
    max-abs weight of every linear lands on that tie, since its scale is
    ``max|w| / qmax``."""
    m = qmax(bits)
    q = ste_round(x / scale)
    lim = torch.full((), float(m), dtype=q.dtype, device=q.device)
    return torch.minimum(torch.maximum(q, -lim), lim) * scale


def code_histogram(values, scale, bits: int = 8) -> np.ndarray:
    """Empirical code distribution of ``values`` quantized at ``scale``:
    a (2^bits,) f64 numpy histogram indexed by the RAW two's-complement
    bit pattern (``code & (2^bits − 1)``, the order of
    ``core.gates.operand_bit_table`` rows), normalized to sum to 1.

    As the reference: f64 division by ``float(scale)``, round-half-even,
    clip to ±qmax.  It runs on the tensor's device (numpy input on the
    CPU); f64 division and rounding are the same IEEE operations there."""
    m = qmax(bits)
    v = torch.as_tensor(values).to(torch.float64)
    codes = torch.clamp(torch.round(v / float(scale)), -m, m).to(torch.int64)
    raw = codes & ((1 << bits) - 1)
    hist = torch.bincount(raw.reshape(-1), minlength=1 << bits)
    hist = hist.to(torch.float64).cpu().numpy()
    return hist / max(hist.sum(), 1.0)


def uniform_levels(bits: int = 8) -> torch.Tensor:
    """The representable level codes, ascending (…, -1, 0, 1, …), f32."""
    m = qmax(bits)
    return torch.arange(-m, m + 1, dtype=torch.float32)
