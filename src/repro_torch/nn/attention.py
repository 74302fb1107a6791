"""Self-attention: GQA/MQA/MHA with RoPE, sliding window, logit softcap
(port of ``repro/nn/attention.py``: the no-cache, paged and dense-cache
branches)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.paged_attention import gqa_group, paged_attn
from repro_torch.parallel.mesh import copy_to_model
from repro_torch.parallel.sharding import (local_kv_heads, local_kv_map,
                                           splits)
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

    ``cache``: None (no cache), a paged layer cache ``{pool_k, pool_v,
    [scale_k, scale_v,] pages, lens}`` whose pools are written in place
    (``positions`` is then (B, S) absolute per-row positions), or a dense
    layer cache ``{k, v, pos[, pad]}`` (``init_kv_cache``) whose rows
    ``[pos, pos+S)`` are written in place; ``pad`` (B,) counts each row's
    left-pad slots, and ``positions`` is then (B, S) logical positions
    (negative on the pads).  ``window``: this layer's sliding window (None
    = global).

    Under a mesh whose model axis divides the heads (``splits``) the
    block runs on this rank's ``Hq/TP`` q and ``Hkv/TP`` kv heads (its
    column shards of wq/wk/wv, its row shard of wo) and its caches hold
    those kv heads; the output is summed over the ranks in ``wo``."""
    B, S, _ = x.shape
    hd = cfg.head_dim_r
    cdt = cfg.cdtype
    tp = splits(cfg)["attn"]
    hq, hkv = cfg.n_heads_p // tp, cfg.n_kv_p // tp
    if tp > 1:
        # training: the input's gradient, and the q/k norms' (applied to
        # this rank's heads only), summed over the model axis
        x = copy_to_model(x)
        if cfg.qk_norm:
            p = dict(p, **{k: copy_to_model(p[k])
                           for k in ("qnorm_g", "knorm_g")})
    q = linear(p, "wq", x, cfg.mac, cdt, tp).reshape(B, S, hq, hd)
    k = linear(p, "wk", x, cfg.mac, cdt, tp).reshape(B, S, hkv, hd)
    v = linear(p, "wv", x, cfg.mac, cdt, tp).reshape(B, S, hkv, hd)
    if cfg.qk_norm:
        q = norm_apply(p, q, "rms", cfg.norm_eps, "qnorm")
        k = norm_apply(p, k, "rms", cfg.norm_eps, "knorm")
    if positions is None:
        positions = torch.arange(S, device=x.device)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    scale = cfg.attn_scale or (1.0 / math.sqrt(hd))
    kv_map = local_kv_map(cfg, tp)
    pad = None if cache is None else cache.get("pad")

    def parallel_attn(q, k, v):
        k_valid = None if pad is None else positions >= 0   # left-pad keys
        return mha(q, k, v, kv_map, scale=scale, q_pos=positions,
                   k_pos=positions, window=window, cap=cfg.attn_softcap,
                   chunk=cfg.attn_chunk, k_valid=k_valid)

    new_cache = None
    if cache is None:
        # the reference routes this branch through its flash kernel when
        # cfg.flash_attention is set and the window is None or an int
        # (src/repro/nn/attention.py:110-111), but its model hands every
        # layer its window as an array (src/repro/models/lm.py:337-341,
        # src/repro/nn/blocks.py:27-31,63), so that gate never opens and
        # it runs mha; the port does the same (kernels.ops.flash_mha stays
        # off the model path)
        out = parallel_attn(q, k, v)
    elif "pool_k" in cache:
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
                 and gqa_group(kv_map, hq, hkv) is not None)
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
    else:
        # dense cache: write K/V at [pos, pos+S) in place.  ``pos`` may be
        # a device tensor (a captured decode step reads it from its input
        # buffer) or an int
        ck, cv, pos = cache["k"], cache["v"], cache["pos"]
        rows = pos + torch.arange(S, device=x.device)
        ck.index_copy_(1, rows, k.to(ck.dtype))
        cv.index_copy_(1, rows, v.to(cv.dtype))
        if S > 1:
            # prefill (from position 0) attends over the fresh K/V
            out = parallel_attn(q, k, v)
        else:
            # decode: the whole max_len row; slot s of a left-padded row
            # holds its token at logical position s - pad (pads masked)
            k_pos = torch.arange(ck.shape[1], device=x.device)
            k_valid = k_pos < pos + S
            if pad is not None:
                k_valid = k_valid[None, :] & (k_pos[None, :] >= pad[:, None])
                k_pos = k_pos[None, :] - pad[:, None]
            out = mha(q, ck, cv, kv_map, scale=scale, q_pos=positions,
                      k_pos=k_pos, window=window, cap=cfg.attn_softcap,
                      chunk=0, k_valid=k_valid)
        new_cache = {"k": ck, "v": cv, "pos": pos + S}
    out = out.reshape(B, S, hq * hd)
    return linear(p, "wo", out, cfg.mac, cdt, tp), new_cache


def init_kv_cache(cfg, batch: int, max_len: int, n_layers: int, *,
                  device) -> list:
    """Per layer a dense ``{k, v}`` of zeros ``(batch, max_len, n_kv,
    hd)`` in the compute dtype (the reference stacks them ``(L, …)``);
    under a mesh, this rank's kv heads (``local_kv_heads``)."""
    shape = (batch, max_len, local_kv_heads(cfg), cfg.head_dim_r)
    return [{"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}
            for _ in range(n_layers)]
