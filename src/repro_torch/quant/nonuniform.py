"""4-bit non-uniform quantization (DKM-style k-means codebooks), paper §4
(port of ``repro/quant/nonuniform.py``).

Levels are learned per tensor by Lloyd iterations; for execution on the
general-purpose encoded MAC array they are mapped to the nearest 8-bit
uniform levels.  For the task-specific array (Fig 7) the raw level
products feed the encoding search directly.

As the reference: ``argmin`` takes the first index on a tie, an empty
cluster keeps its centre, 25 Lloyd steps, then a sort.  A cluster's sum
is an f32 product ``one.T @ flat`` whose order differs from XLA's, so a
level may move by an ulp and a value at a midpoint between two levels
may take the other code.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .uniform import qmax


def kmeans_levels(x, bits: int = 4, iters: int = 25) -> torch.Tensor:
    """1-D k-means (2^bits centroids, evenly spaced to start) over the
    values of ``x`` (a tensor or array), on its device; returns the levels
    sorted."""
    k = 1 << bits
    flat = torch.as_tensor(x).reshape(-1).to(torch.float32)
    lo, hi = flat.min(), flat.max()
    centers = lo + (hi - lo) * (torch.arange(
        k, dtype=torch.float32, device=flat.device) + 0.5) / k
    for _ in range(iters):
        d = (flat[None, :] - centers[:, None]).abs()           # (k, n)
        one = F.one_hot(d.argmin(0), k).to(torch.float32)      # (n, k)
        cnt = one.sum(0)
        tot = one.T @ flat
        centers = torch.where(cnt > 0, tot / cnt.clamp_min(1.0), centers)
    return torch.sort(centers).values


def nonuniform_codes(x: torch.Tensor, levels: torch.Tensor) -> torch.Tensor:
    """Nearest-level code assignment: int8 codes in [0, len(levels))."""
    d = (x[..., None] - levels).abs()
    return d.argmin(-1).to(torch.int8)


def map_levels_to_int8(levels: torch.Tensor, scale, bits: int = 8
                       ) -> torch.Tensor:
    """Snap non-uniform levels to the nearest 8-bit uniform codes."""
    m = qmax(bits)
    return torch.clamp(torch.round(levels / scale), -m, m).to(torch.int8)
