"""Float32 oracle for the encoded bitplane matmul (port of
``repro/kernels/ref.py``):

    out[m, n] = Σ_u A_u(x)[m, k] @ Wt[u, k, n] + bias[n]

where A_u(x) is the AND of the operand bits listed in ``mono_bits[u]``.
"""
from __future__ import annotations

import numpy as np
import torch


def planes_ref(x_codes: torch.Tensor, mono_bits) -> torch.Tensor:
    """(…,) int codes → (U, …) {0,1} int8 planes; ``mono_bits`` (U, 3)."""
    v = x_codes.to(torch.int32)[None]
    mb = torch.tensor(np.asarray(mono_bits, np.int32),
                      device=x_codes.device)
    idx = (slice(None),) + (None,) * x_codes.ndim
    p = (v >> mb[idx + (0,)]) & (v >> mb[idx + (1,)]) \
        & (v >> mb[idx + (2,)]) & 1
    return p.to(torch.int8)


def encoded_matmul_ref(x_codes, wt, bias, mono_bits) -> torch.Tensor:
    """Oracle: (m,k) int8, (U,k,n), (n,) f32 → (m,n) f32, all in f32."""
    A = planes_ref(x_codes, mono_bits).to(torch.float32)      # (U, m, k)
    return torch.einsum("umk,ukn->mn", A, wt.to(torch.float32)) + bias
