"""Multi-head Latent Attention (DeepSeek-V2/V3) with decoupled RoPE (port
of ``repro/nn/mla.py``).

The cache holds only the shared latent per token: ``ckv (B, T, r)`` and
the rotated key part ``kr (B, T, rope_dim)``.  Prefill (and training)
expands per-head K/V with the ``wk_b``/``wv_b`` linears, which run under
the MAC executor (kernel 1 when encoded), and attends through ``mha``.
Decode reads the raw ``wk_b``/``wv_b`` weights in f32, as the reference
does, by one of two paths:

  - naive: expand per-head K/V from the whole cached latent every step;
  - absorbed (``cfg.mla_absorb``): fold ``wk_b`` into q and ``wv_b`` after
    the probability-weighted latent sum.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.mesh import copy_to_model
from repro_torch.parallel.sharding import splits
from .attention_mha import NEG_INF, mha, softmax_f32
from .common import apply_rope, linear, linear_init, norm_apply, norm_init

_F32 = torch.float32


def mla_init(generator, cfg) -> dict:
    d, H = cfg.d_model, cfg.n_heads_p
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    p = {}
    p.update(linear_init(generator, d, cfg.q_lora_rank, "wq_a", cfg.mac,
                         False, cfg.pdtype))
    p.update(norm_init(cfg.q_lora_rank, "rms", cfg.pdtype, "qa_norm"))
    p.update(linear_init(generator, cfg.q_lora_rank, H * (dn + dr), "wq_b",
                         cfg.mac, False, cfg.pdtype))
    p.update(linear_init(generator, d, cfg.kv_lora_rank, "wkv_a", cfg.mac,
                         False, cfg.pdtype))
    p.update(norm_init(cfg.kv_lora_rank, "rms", cfg.pdtype, "kva_norm"))
    p.update(linear_init(generator, d, dr, "wkr", cfg.mac, False,
                         cfg.pdtype))
    p.update(linear_init(generator, cfg.kv_lora_rank, H * dn, "wk_b",
                         cfg.mac, False, cfg.pdtype))
    p.update(linear_init(generator, cfg.kv_lora_rank, H * dv, "wv_b",
                         cfg.mac, False, cfg.pdtype))
    p.update(linear_init(generator, H * dv, d, "wo", cfg.mac, False,
                         cfg.pdtype))
    return p


def _q_proj(p, x, cfg, tp):
    B, S, _ = x.shape
    H = cfg.n_heads_p // tp
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = norm_apply(p, linear(p, "wq_a", x, cfg.mac, cfg.cdtype),
                    "rms", cfg.norm_eps, "qa_norm")
    q = linear(p, "wq_b", cq, cfg.mac, cfg.cdtype, tp).reshape(
        B, S, H, dn + dr)
    return q[..., :dn], q[..., dn:]


def mla_apply(p: dict, x: torch.Tensor, cfg, *, cache=None, positions=None):
    """MLA over x (B, S, d) → (out, new_cache_or_None).

    ``cache``: None, or a dense layer cache ``{ckv, kr, pos}``
    (``init_mla_cache``) whose rows ``[pos, pos+S)`` are written in place;
    ``pos`` an int or a 0-d tensor.  S > 1 with a cache is a prefill from
    ``pos`` 0, S == 1 a decode step over the whole cache row.

    Under a mesh whose model axis divides the heads (``splits``) the
    block runs on this rank's ``H/TP`` heads: its column shards of
    ``wq_b``/``wk_b``/``wv_b`` (raw and folded, whole heads each) and its
    row shard of ``wo``, whose partials are summed over the ranks; the
    latent and the rotated key, and the cache that holds them, are whole
    on every rank."""
    B, S, _ = x.shape
    tp = splits(cfg)["mla"]
    H = cfg.n_heads_p // tp
    if tp > 1:
        # training: the input's gradient summed over the model axis
        x = copy_to_model(x)
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    scale = 1.0 / np.sqrt(dn + dr)
    if positions is None:
        pos0 = 0 if cache is None else cache["pos"]
        positions = pos0 + torch.arange(S, device=x.device)

    qn, qr = _q_proj(p, x, cfg, tp)
    qr = apply_rope(qr, positions, cfg.rope_theta)
    ckv = norm_apply(p, linear(p, "wkv_a", x, cfg.mac, cfg.cdtype),
                     "rms", cfg.norm_eps, "kva_norm")         # (B,S,r)
    kr = apply_rope(linear(p, "wkr", x, cfg.mac, cfg.cdtype)
                    .reshape(B, S, 1, dr), positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        cc, ckr, pos = cache["ckv"], cache["kr"], cache["pos"]
        rows = pos + torch.arange(S, device=x.device)
        cc.index_copy_(1, rows, ckv.to(cc.dtype))
        ckr.index_copy_(1, rows, kr[:, :, 0].to(ckr.dtype))
        new_cache = {"ckv": cc, "kr": ckr, "pos": pos + S}
    if cache is None or S > 1:
        # parallel path (training, or prefill from 0 with the cache
        # written above): per-head K/V expanded by the wk_b/wv_b linears
        kn = linear(p, "wk_b", ckv, cfg.mac, cfg.cdtype, tp).reshape(
            B, S, H, dn)
        v = linear(p, "wv_b", ckv, cfg.mac, cfg.cdtype, tp).reshape(
            B, S, H, dv)
        k = torch.cat([kn, kr.expand(B, S, H, dr)], -1)
        q = torch.cat([qn, qr.expand(B, S, H, dr)], -1)
        out = mha(q, k, v, np.arange(H, dtype=np.int32), scale=scale,
                  q_pos=positions, k_pos=positions, chunk=cfg.attn_chunk)
    else:
        Smax = cc.shape[1]
        valid = torch.arange(Smax, device=x.device) < pos + S
        ccf = cc.to(_F32)
        score_r = torch.einsum("bshd,btd->bhst", qr.to(_F32), ckr.to(_F32))
        wkb = p["wk_b"].to(_F32).reshape(r, H, dn)
        if cfg.mla_absorb:
            qt = torch.einsum("bshn,rhn->bshr", qn.to(_F32), wkb)
            score_n = torch.einsum("bshr,btr->bhst", qt, ccf)
        else:
            kn = torch.einsum("btr,rhn->bthn", ccf, wkb)
            score_n = torch.einsum("bshn,bthn->bhst", qn.to(_F32), kn)
        lg = (score_n + score_r) * float(scale)
        lg = torch.where(valid[None, None, None, :], lg,
                         torch.full((), NEG_INF, dtype=_F32,
                                    device=x.device))
        prob = softmax_f32(lg)
        wvb = p["wv_b"].to(_F32).reshape(r, H, dv)
        if cfg.mla_absorb:
            o_lat = torch.einsum("bhst,btr->bshr", prob, ccf)
            out = torch.einsum("bshr,rhv->bshv", o_lat, wvb)
        else:
            v = torch.einsum("btr,rhv->bthv", ccf, wvb)
            out = torch.einsum("bhst,bthv->bshv", prob, v)
        out = out.to(cfg.cdtype)

    out = out.reshape(B, S, H * dv)
    return linear(p, "wo", out, cfg.mac, cfg.cdtype, tp), new_cache


def init_mla_cache(cfg, batch: int, max_len: int, n_layers: int, *,
                   device) -> list:
    """Per layer a dense ``{ckv (batch, max_len, r), kr (batch, max_len,
    rope_dim)}`` of zeros in the compute dtype (the reference stacks them
    ``(L, …)``)."""
    dt = cfg.cdtype
    return [{"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=dt, device=device),
             "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dt,
                               device=device)}
            for _ in range(n_layers)]

