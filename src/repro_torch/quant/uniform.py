"""Uniform symmetric quantization (port of ``repro/quant/uniform.py``).

Codes are signed integers in [-(2^{b-1}-1), 2^{b-1}-1]; rounding is
round-half-even (``torch.round``) on the f32 quotient ``x / scale`` —
never ``x * (1 / scale)``, which rounds differently at .5 boundaries."""
from __future__ import annotations

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
