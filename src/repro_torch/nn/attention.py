"""Self-attention: GQA/MQA/MHA with RoPE, sliding window, logit softcap
(port of ``repro/nn/attention.py``: the no-cache branch and the paged
branch; the dense decode cache waits with ``generate``)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.paged_attention import gqa_group, paged_attn
from .attention_mha import mha
from .common import apply_rope, linear, linear_init, norm_apply, norm_init
from .paged import (gather_kv, gather_kv_dequant, paged_attn_decode,
                    scatter_kv, scatter_kv_quant)


def kv_of_q_map(n_heads: int, n_kv: int, n_heads_p: int, n_kv_p: int
                ) -> np.ndarray:
    """Static q-head → kv-head index map preserving the original grouping;
    MHA with equal padding keeps the identity map."""
    group = max(1, n_heads // max(n_kv, 1))
    if group == 1 and n_heads_p == n_kv_p:
        return np.arange(n_heads_p, dtype=np.int32)
    idx = np.minimum(np.arange(n_heads_p) // group, n_kv_p - 1)
    idx[n_heads:] = n_kv_p - 1          # padded q heads → last (padded) kv
    return idx.astype(np.int32)


def attn_init(generator, cfg, d_model: Optional[int] = None) -> dict:
    d = d_model or cfg.d_model
    hd = cfg.head_dim_r
    p = {}
    p.update(linear_init(generator, d, cfg.n_heads_p * hd, "wq", cfg.mac,
                         cfg.qkv_bias, cfg.pdtype))
    p.update(linear_init(generator, d, cfg.n_kv_p * hd, "wk", cfg.mac,
                         cfg.qkv_bias, cfg.pdtype))
    p.update(linear_init(generator, d, cfg.n_kv_p * hd, "wv", cfg.mac,
                         cfg.qkv_bias, cfg.pdtype))
    wo = linear_init(generator, cfg.n_heads_p * hd, d, "wo", cfg.mac,
                     cfg.attn_out_bias, cfg.pdtype)
    if cfg.n_heads_p != cfg.n_heads:    # zero padded-head output rows
        wo["wo"] = wo["wo"].reshape(cfg.n_heads_p, hd, d)
        wo["wo"][cfg.n_heads:] = 0
        wo["wo"] = wo["wo"].reshape(cfg.n_heads_p * hd, d)
    p.update(wo)
    if cfg.qk_norm:
        p.update(norm_init(hd, "rms", cfg.pdtype, "qnorm"))
        p.update(norm_init(hd, "rms", cfg.pdtype, "knorm"))
    return p


def attn_apply(p: dict, x: torch.Tensor, cfg, *, window=None, cache=None,
               positions=None):
    """Self-attention over x (B, S, d) → (out, new_cache_or_None).

    ``cache``: None (no cache) or a paged layer cache ``{pool_k, pool_v,
    [scale_k, scale_v,] pages, lens}`` whose pools are written in place
    (``positions`` is then (B, S) absolute per-row positions).  ``window``:
    this layer's sliding window (None = global)."""
    B, S, _ = x.shape
    hd = cfg.head_dim_r
    cdt = cfg.cdtype
    q = linear(p, "wq", x, cfg.mac, cdt).reshape(B, S, cfg.n_heads_p, hd)
    k = linear(p, "wk", x, cfg.mac, cdt).reshape(B, S, cfg.n_kv_p, hd)
    v = linear(p, "wv", x, cfg.mac, cdt).reshape(B, S, cfg.n_kv_p, hd)
    if cfg.qk_norm:
        q = norm_apply(p, q, "rms", cfg.norm_eps, "qnorm")
        k = norm_apply(p, k, "rms", cfg.norm_eps, "knorm")
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    scale = cfg.attn_scale or (1.0 / math.sqrt(hd))
    kv_map = kv_of_q_map(cfg.n_heads, cfg.n_kv_heads, cfg.n_heads_p,
                         cfg.n_kv_p)
    new_cache = None
    if cache is None:
        # the reference routes this branch through its flash kernel when
        # cfg.flash_attention is set and the window is None or an int
        # (src/repro/nn/attention.py:110-111), but its model hands every
        # layer its window as an array (src/repro/models/lm.py:337-341,
        # src/repro/nn/blocks.py:27-31,63), so that gate never opens and
        # it runs mha; the port does the same (kernels.ops.flash_mha stays
        # off the model path)
        out = mha(q, k, v, kv_map, scale=scale, q_pos=positions,
                  k_pos=positions, window=window, cap=cfg.attn_softcap,
                  chunk=cfg.attn_chunk)
    else:
        # paged serving: write through into the page pools (in place),
        # then attend through the page table.  Decode steps with a regular
        # GQA layout take the fused page-walk op when attention_backend is
        # 'kernel'; everything else keeps the gathered-view path.
        # Quantized pools carry scale_k/scale_v side pools: fresh K/V
        # quantizes on scatter, the fused op dequantizes inside its page
        # loop, and the gather path dequantizes its page view.
        pages, lens = cache["pages"], cache["lens"]
        pk, pv = cache["pool_k"], cache["pool_v"]
        sk, sv = cache.get("scale_k"), cache.get("scale_v")
        quant = sk is not None
        if quant:
            scatter_kv_quant(pk, sk, pages, positions, k)
            scatter_kv_quant(pv, sv, pages, positions, v)
        else:
            scatter_kv(pk, pages, positions, k)
            scatter_kv(pv, pages, positions, v)
        fused = (S <= max(1, cfg.paged_fused_max_sq)
                 and cfg.attention_backend == "kernel"
                 and gqa_group(kv_map, cfg.n_heads_p, cfg.n_kv_p)
                 is not None)
        if fused:
            out = paged_attn(q, pk, pv, pages, lens, scale=scale,
                             window=window, cap=cfg.attn_softcap,
                             kv_of_q=kv_map, scale_k=sk, scale_v=sv)
        else:
            if quant:
                ck = gather_kv_dequant(pk, sk, pages)
                cv = gather_kv_dequant(pv, sv, pages)
            else:
                ck, cv = gather_kv(pk, pages), gather_kv(pv, pages)
            k_pos = torch.arange(ck.shape[1], device=x.device)
            k_valid = k_pos[None, :] < (lens.long() + S)[:, None]
            out = paged_attn_decode(q, ck, cv, kv_map, scale=scale,
                                    q_pos=positions.long(), k_pos=k_pos,
                                    k_valid=k_valid, window=window,
                                    cap=cfg.attn_softcap)
        new_cache = {"pool_k": pk, "pool_v": pv}
        if quant:
            new_cache.update(scale_k=sk, scale_v=sv)
    out = out.reshape(B, S, cfg.n_heads_p * hd)
    return linear(p, "wo", out, cfg.mac, cdt), new_cache
