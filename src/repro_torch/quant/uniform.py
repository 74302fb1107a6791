"""Uniform symmetric quantization (port of ``repro/quant/uniform.py``).

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
