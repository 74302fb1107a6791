"""MAC backend registry — the single dispatch point for linear-layer MAC
execution (port of ``repro/core/macexec.py``: the registry, ``FpExecutor``
and ``EncodedInferExecutor``).

An executor owns its param-suffix schema (``_fw``/``_fb`` folded bitplane
tensors, ``_as``/``_ws`` activation/weight scales), init and apply.
"""
from __future__ import annotations

import math

import torch

from repro_torch.quant.uniform import quantize_codes

_REGISTRY: dict = {}


def register(cls):
    """Class decorator: register a MacExecutor under ``cls.mode``."""
    _REGISTRY[cls.mode] = cls()
    return cls


def get_executor(mode: str) -> "MacExecutor":
    try:
        return _REGISTRY[mode]
    except KeyError:
        raise ValueError(f"unknown MAC mode {mode!r}; registered modes: "
                         f"{sorted(_REGISTRY)}") from None


def mm(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Matmul in the compute dtype (f32 accumulation; a plain product left
    to PyTorch as the reference leaves it to XLA)."""
    return torch.matmul(x.to(compute_dtype), w.to(compute_dtype))


class MacExecutor:
    """Base executor: fp weight init, no auxiliary leaves."""
    mode: str = "?"
    param_suffixes: tuple = ()
    requires_prepared_params: bool = False

    def init(self, generator: torch.Generator, d_in: int, d_out: int,
             name: str, mcfg, dtype=torch.float32, scale=None) -> dict:
        std = scale if scale is not None else 1.0 / math.sqrt(d_in)
        w = torch.randn((d_in, d_out), generator=generator,
                        dtype=torch.float32) * std
        return {name: w.to(dtype)}

    def apply(self, p: dict, name: str, x: torch.Tensor, mcfg,
              compute_dtype) -> torch.Tensor:
        raise NotImplementedError


@register
class FpExecutor(MacExecutor):
    """Plain fp matmul."""
    mode = "fp"

    def apply(self, p, name, x, mcfg, compute_dtype):
        return mm(x, p[name], compute_dtype)


@register
class EncodedInferExecutor(MacExecutor):
    """Serving path: weights pre-folded once into bf16 (U, k, n) bitplane
    tensors + f32 bias by ``repro_torch.serve.encoded.
    prepare_encoded_serving``; applies through ``kernels.ops.
    encoded_matmul``.  Linears without folded tensors fall back to the fp
    matmul — the gate is per layer, not global."""
    mode = "encoded_infer"
    param_suffixes = ("_fw", "_fb", "_as", "_ws")
    requires_prepared_params = True

    def init(self, generator, d_in, d_out, name, mcfg, dtype=torch.float32,
             scale=None):
        raise ValueError(
            "'encoded_infer' params are built from fp params by "
            "repro_torch.serve.encoded.prepare_encoded_serving, not "
            "initialized")

    def apply(self, p, name, x, mcfg, compute_dtype):
        if name + "_fw" not in p:
            return mm(x, p[name], compute_dtype)
        from repro_torch.kernels.ops import encoded_matmul
        lead = x.shape[:-1]
        # reference order: f32 input → int8 codes → kernel → × (sa·sw) →
        # compute dtype
        x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
        sa, sw = p[name + "_as"], p[name + "_ws"]
        xc = quantize_codes(x2, sa, mcfg.bits)
        out = encoded_matmul(xc, p[name + "_fw"], p[name + "_fb"],
                             mcfg.mac_for(name).program.a_mono_tuples)
        return (out * (sa * sw)).reshape(*lead, -1).to(compute_dtype)
