"""Paged KV-pool layout (port of the dense part of
``repro/quant/kvcache.py``).  Only the ``bf16`` mode — dense pages in the
compute dtype — is ported; int8/int4 pools wait (ROADMAP: quantized KV
pools)."""
from __future__ import annotations

import torch

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
    """(pool_dtype, head_dim, quantized?) for ``cfg``'s paged pools."""
    mode = getattr(cfg, "kv_cache_dtype", "bf16")
    if mode != "bf16":
        raise NotImplementedError(
            f"kv_cache_dtype={mode!r} is not ported yet (ROADMAP: int8/int4 "
            "pools with in-kernel dequant); use 'bf16'")
    return cfg.cdtype, cfg.head_dim_r, False
