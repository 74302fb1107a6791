"""KV-cache quantization for the paged serving pools (port of
``repro/quant/kvcache.py``).

Layout (``cfg.kv_cache_dtype``):

  * ``bf16`` — dense storage in ``cfg.cdtype``.  No scale pools.
  * ``int8`` — symmetric per-token per-kv-head scales:
    ``q = clip(round(x / (s + 1e-12)), -127, 127)`` with
    ``s = amax|x| / 127`` over the head_dim axis.  Pool dtype int8.
  * ``int4`` — the same with ``s = amax|x| / 7``; two values per byte
    along head_dim (low nibble dim ``i``, high nibble dim ``i + D/2``),
    stored offset by 8 so zero bytes decode to -8; pool dtype uint8 at
    ``head_dim // 2``.

Scales live in f32 side pools ``scale_k/scale_v (n_pages, page_size,
n_kv)`` beside each layer's value pools.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the codes equal the reference's.
"""
from __future__ import annotations

import torch

KV_DTYPES = ("bf16", "int8", "int4")
_EPS = 1e-12                      # guards 0/0 on all-zero rows
_LEVELS = {"int8": 127.0, "int4": 7.0}


def kv_mode_of(pool) -> str:
    """Classify a pool (or its dtype): int8 → 'int8', uint8 → packed
    'int4', floats → dense 'bf16'."""
    dt = pool.dtype if hasattr(pool, "dtype") else pool
    if dt == torch.int8:
        return "int8"
    if dt == torch.uint8:
        return "int4"
    return "bf16"


def kv_pool_layout(cfg):
    """(pool_dtype, packed_head_dim, quantized?) for ``cfg``'s paged
    pools; raises on an unknown mode and on an odd head_dim for int4."""
    mode = getattr(cfg, "kv_cache_dtype", "bf16")
    hd = cfg.head_dim_r
    if mode == "int8":
        return torch.int8, hd, True
    if mode == "int4":
        if hd % 2:
            raise ValueError(
                f"kv_cache_dtype='int4' packs head_dim pairs per byte; "
                f"head_dim {hd} must be even")
        return torch.uint8, hd // 2, True
    if mode != "bf16":
        raise ValueError(f"unknown kv_cache_dtype {mode!r}; expected one "
                         f"of {KV_DTYPES}")
    return cfg.cdtype, hd, False


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int levels in [-7, 7] (last axis = head_dim, even) into uint8
    nibbles: byte ``i`` holds dim ``i`` (low) and dim ``i + D/2`` (high),
    each stored as ``level + 8``."""
    D = q.shape[-1]
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    lo, hi = u[..., : D // 2], u[..., D // 2:]
    return lo | (hi << 4)


def unpack_int4(b: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4`` → f32 levels (zero bytes, never written,
    decode to -8 and are masked or zero-scaled upstream)."""
    lo = (b & 0xF).to(torch.float32) - 8.0
    hi = (b >> 4).to(torch.float32) - 8.0
    return torch.cat([lo, hi], dim=-1)


def quantize_kv(val: torch.Tensor, mode: str):
    """Quantize fresh K/V rows ``val (..., H, D)`` → ``(q, scale)``: ``q``
    in the pool's storage dtype and width, ``scale (..., H)`` f32.

    The divisions take a tensor divisor: PyTorch on CUDA turns a division
    by a Python scalar into a multiplication by its reciprocal, which can
    move a scale by one ulp from the CPU's (and the reference's)."""
    if mode not in _LEVELS:
        raise ValueError(f"quantize_kv: dense mode {mode!r} has no scales")
    f = val.to(torch.float32)
    levels = torch.tensor(_LEVELS[mode], dtype=torch.float32,
                          device=f.device)
    s = f.abs().amax(dim=-1) / levels
    q = torch.clamp(torch.round(f / (s[..., None] + _EPS)), -levels, levels)
    if mode == "int8":
        return q.to(torch.int8), s
    return pack_int4(q.to(torch.int8)), s


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """Dequantize pool rows ``q (..., H, Dp)`` with ``scale (..., H)`` →
    f32 ``(..., H, D)``; the op the kernel does inside its page loop."""
    if mode == "int8":
        f = q.to(torch.float32)
    elif mode == "int4":
        f = unpack_int4(q)
    else:
        raise ValueError(f"dequantize_kv: dense mode {mode!r}")
    return f * scale.to(torch.float32)[..., None]
