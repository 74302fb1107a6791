"""The encoded-MAC handle models carry, its artifacts, the LUT oracle and
the QAT matmul (port of ``repro/core/mac.py``).

Encodings are saved as ``<dir>/<name>.json`` in the reference's schema
(``{"circuit": …, "s": […], "rmse": …}``), so either package reads the
other's files.  The default 48-bit encoding of the 8×8-bit multiplier is
searched once and cached under the port's own ``core/artifacts/``
(git-ignored)."""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from .circuits import Circuit
from .encoding import EncodingSpec
from .decompose import BitplaneProgram, decompose

_ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "artifacts")


@dataclasses.dataclass
class EncodedMac:
    """Bundle of (spec, program)."""
    spec: EncodingSpec
    program: BitplaneProgram

    @property
    def s_init(self) -> np.ndarray:
        return self.spec.s

    @staticmethod
    def from_spec(spec: EncodingSpec) -> "EncodedMac":
        return EncodedMac(spec, decompose(spec.circuit))

    @staticmethod
    def load(name: str, artifact_dir: Optional[str] = None) -> "EncodedMac":
        """Load ``<dir>/<name>.json``; ``name`` may contain
        subdirectories."""
        path = os.path.join(artifact_dir or _ARTIFACT_DIR, name + ".json")
        with open(path) as f:
            d = json.load(f)
        circ = Circuit.from_json(json.dumps(d["circuit"]))
        circ.validate()
        spec = EncodingSpec(circ, np.asarray(d["s"], np.float32),
                            float(d["rmse"]))
        return EncodedMac.from_spec(spec)

    @staticmethod
    def save(spec: EncodingSpec, name: str,
             artifact_dir: Optional[str] = None) -> str:
        path = os.path.join(artifact_dir or _ARTIFACT_DIR, name + ".json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"circuit": json.loads(spec.circuit.to_json()),
                       "s": np.asarray(spec.s, np.float32).tolist(),
                       "rmse": float(spec.rmse)}, f)
        return path

    @staticmethod
    def default(name: str = "enc48_8x8", m_bits: int = 48,
                n_samples: int = 512, refine: int = 512,
                seed: int = 0, device=None) -> "EncodedMac":
        """Load the cached default encoding; search (on ``device``,
        default: the card) and cache it on first use."""
        try:
            return EncodedMac.load(name)
        except FileNotFoundError:
            from .search import anneal, random_search
            res = random_search(seed, m_bits, n_samples, device=device)
            if refine:
                res = anneal(res.spec, seed + 1, refine, device=device)
            EncodedMac.save(res.spec, name)
            return EncodedMac.from_spec(res.spec)


def lut_matmul(x_codes: torch.Tensor, w_codes: torch.Tensor,
               lut: torch.Tensor, bits_a: int = 8, bits_b: int = 8
               ) -> torch.Tensor:
    """out[m, n] = Σ_k lut[x[m,k], w[k,n]] — the functional ground truth.

    ``lut`` is indexed by raw (two's-complement) codes, a-code-major.
    O(m·k·n) gathers: for tests and small shapes only."""
    xi = x_codes.to(torch.int64) & ((1 << bits_a) - 1)
    wi = w_codes.to(torch.int64) & ((1 << bits_b) - 1)
    flat = torch.as_tensor(lut, device=x_codes.device).reshape(-1)
    idx = xi[:, :, None] * (1 << bits_b) + wi[None, :, :]
    return flat[idx].sum(dim=1)


def encoded_matmul_qat(x: torch.Tensor, w: torch.Tensor, scale_x, scale_w,
                       s: torch.Tensor, program: BitplaneProgram,
                       bits: int = 8) -> torch.Tensor:
    """Differentiable encoded matmul.

    Forward: quantize → encoded (bitplane) matmul → rescale.  Backward:
    exact position-weight gradients (the output is linear in ``s``);
    straight-through (fp matmul) gradients for ``x`` and ``w`` — the
    paper's STE fine-tuning scheme."""
    from repro_torch.quant.uniform import quantize_codes
    # a named range for torch.profiler (the fold's share of a train step)
    with torch.profiler.record_function("qat_fold"):
        xc = quantize_codes(x.detach(), scale_x, bits)
        wc = quantize_codes(w.detach(), scale_w, bits)
        approx = program.apply_f32(xc, wc, s) * (scale_x * scale_w)
    exact = x @ w
    # value == approx; d/ds via approx; d/dx, d/dw via the exact term (STE)
    return approx + (exact - exact.detach())
