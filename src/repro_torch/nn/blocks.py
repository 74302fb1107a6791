"""Blocks of every family (port of ``repro/nn/blocks.py``): GQA attention
or MLA, then a dense MLP or a mixture of experts; Hymba's attention and
SSM heads in parallel, then a dense MLP; the xLSTM's mLSTM and sLSTM
blocks; Whisper's encoder block and its decoder block with
cross-attention.  Every decoder block is (init, apply) with
apply(params, x, cfg, *, …, cache) → (x_out, new_cache, aux), ``aux``
the router's auxiliary loss (0 but for a MoE layer)."""
from __future__ import annotations

import math

import torch

from .attention import attn_apply, attn_init
from .attention_mha import mha
from .common import linear, mlp_apply, mlp_init, norm_apply, norm_init
from .mla import mla_apply, mla_init
from .moe import moe_apply, moe_init
from .ssm import ssm_apply, ssm_init
from .xlstm import mlstm_apply, mlstm_init, slstm_apply, slstm_init
from repro_torch.parallel.mesh import copy_to_model
from repro_torch.parallel.sharding import local_kv_map, splits


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


def decoder_block_init(generator, cfg, ffn: str = "dense") -> dict:
    p = {}
    if cfg.use_mla:
        p["mla"] = mla_init(generator, cfg)
    else:
        p["attn"] = attn_init(generator, cfg)
    if ffn == "moe":
        p["moe"] = moe_init(generator, cfg)
    else:
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mac,
                            cfg.gated_mlp, cfg.mlp_bias, cfg.pdtype)
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln1"))
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln2"))
    if cfg.post_norm:
        p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln1p"))
        p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln2p"))
    return p


def decoder_block_apply(p, x, cfg, *, ffn: str = "dense", window=None,
                        cache=None, positions=None):
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln1")
    if cfg.use_mla:
        a, new_cache = mla_apply(p["mla"], h, cfg, cache=cache,
                                 positions=positions)
    else:
        a, new_cache = attn_apply(p["attn"], h, cfg, window=window,
                                  cache=cache, positions=positions)
    if cfg.post_norm:
        a = norm_apply(p, a, cfg.norm, cfg.norm_eps, "ln1p")
    x = x + a
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln2")
    if ffn == "moe":
        f, aux = moe_apply(p["moe"], h, cfg)
    else:
        f = mlp_apply(p["mlp"], h, cfg.mac, cfg.act, cfg.gated_mlp,
                      cfg.cdtype, splits(cfg)["mlp"])
        aux = _zero(x)
    if cfg.post_norm:
        f = norm_apply(p, f, cfg.norm, cfg.norm_eps, "ln2p")
    return x + f, new_cache, aux


# --- hybrid block (Hymba: parallel attention + SSM heads) --------------------

def hybrid_block_init(generator, cfg) -> dict:
    p = {"attn": attn_init(generator, cfg), "ssm": ssm_init(generator, cfg)}
    p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mac,
                        cfg.gated_mlp, cfg.mlp_bias, cfg.pdtype)
    for name in ("ln1", "ln2", "na", "ns"):
        p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, name))
    return p


def hybrid_block_apply(p, x, cfg, *, window=None, cache=None,
                       positions=None):
    """Attention and SSM on ``ln1(x)`` side by side, their normed outputs
    averaged into the residual, then the MLP.  ``cache``: None or
    ``{"attn": a dense layer cache, "ssm": {conv, h}}``; the new cache
    shares the attention's tensors (written in place) and carries the
    SSM's new state."""
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln1")
    ac, sc = (None, None) if cache is None else (cache["attn"], cache["ssm"])
    a, ac2 = attn_apply(p["attn"], h, cfg, window=window, cache=ac,
                        positions=positions)
    s, sc2 = ssm_apply(p["ssm"], h, cfg, cache=sc)
    mix = 0.5 * (norm_apply(p, a, cfg.norm, cfg.norm_eps, "na")
                 + norm_apply(p, s, cfg.norm, cfg.norm_eps, "ns"))
    x = x + mix
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln2")
    f = mlp_apply(p["mlp"], h, cfg.mac, cfg.act, cfg.gated_mlp, cfg.cdtype)
    new_cache = None if cache is None else {"attn": ac2, "ssm": sc2}
    return x + f, new_cache, _zero(x)


# --- xLSTM blocks ------------------------------------------------------------

def mlstm_block_init(generator, cfg) -> dict:
    p = {"mlstm": mlstm_init(generator, cfg)}
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln1"))
    return p


def mlstm_block_apply(p, x, cfg, *, cache=None):
    """x + mLSTM(ln1(x)); ``cache``: None or the layer's ``{C, n, m,
    conv}``, the new one in fresh tensors."""
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln1")
    o, new_cache = mlstm_apply(p["mlstm"], h, cfg, cache=cache)
    return x + o, new_cache, _zero(x)


def slstm_block_init(generator, cfg) -> dict:
    p = {"slstm": slstm_init(generator, cfg)}
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln1"))
    return p


def slstm_block_apply(p, x, cfg, *, cache=None):
    """x + sLSTM(ln1(x)) (its FFN inside); ``cache``: None or the layer's
    ``{h, c, m, n}``, the new one in fresh tensors."""
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln1")
    o, new_cache = slstm_apply(p["slstm"], h, cfg, cache=cache)
    return x + o, new_cache, _zero(x)


# --- encoder block / cross-attention decoder block (whisper) ----------------

def encoder_block_init(generator, cfg) -> dict:
    p = {"attn": attn_init(generator, cfg)}
    p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mac,
                        cfg.gated_mlp, cfg.mlp_bias, cfg.pdtype)
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln1"))
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln2"))
    return p


def _heads(cfg, part: str) -> tuple:
    """(the split, this rank's q heads, its kv heads) of whisper's
    attention ``part`` under the active mesh (``splits``)."""
    tp = splits(cfg)[part]
    return tp, cfg.n_heads_p // tp, cfg.n_kv_p // tp


def encoder_block_apply(p, x, cfg):
    """Bidirectional self-attention block over frames x (B, Se, d): no
    mask, no cache, no rotary.  Under a mesh its attention runs on this
    rank's heads and its MLP on its hidden shard, as a decoder block's."""
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln1")
    B, S, _ = h.shape
    hd = cfg.head_dim_r
    cdt = cfg.cdtype
    tp, hq, hkv = _heads(cfg, "attn")
    if tp > 1:
        h = copy_to_model(h)
    q = linear(p["attn"], "wq", h, cfg.mac, cdt, tp).reshape(B, S, hq, hd)
    k = linear(p["attn"], "wk", h, cfg.mac, cdt, tp).reshape(B, S, hkv, hd)
    v = linear(p["attn"], "wv", h, cfg.mac, cdt, tp).reshape(B, S, hkv, hd)
    pos = torch.arange(S, device=x.device)
    o = mha(q, k, v, local_kv_map(cfg, tp), scale=1.0 / math.sqrt(hd),
            q_pos=pos, k_pos=pos, causal=False, chunk=cfg.attn_chunk)
    o = linear(p["attn"], "wo", o.reshape(B, S, -1), cfg.mac, cdt, tp)
    x = x + o
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln2")
    return x + mlp_apply(p["mlp"], h, cfg.mac, cfg.act, cfg.gated_mlp, cdt,
                         splits(cfg)["mlp"])


def xattn_decoder_block_init(generator, cfg) -> dict:
    p = {"attn": attn_init(generator, cfg), "xattn": attn_init(generator,
                                                                cfg)}
    p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mac,
                        cfg.gated_mlp, cfg.mlp_bias, cfg.pdtype)
    for name in ("ln1", "lnx", "ln2"):
        p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, name))
    return p


def xattn_decoder_block_apply(p, x, enc_kv, cfg, *, cache=None,
                              positions=None):
    """Causal self-attention, then cross-attention to the encoder's
    precomputed ``enc_kv = (k, v)`` (B, Se, n_kv, hd), then the MLP.
    ``cache``: None or a dense layer cache ``{k, v, pos}`` for the
    self-attention (written in place, ``attn_apply``).  Under a mesh each
    attention runs on this rank's heads (``enc_kv`` holds its kv heads,
    ``cross_kv``) and the MLP on its hidden shard."""
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln1")
    a, new_cache = attn_apply(p["attn"], h, cfg, cache=cache,
                              positions=positions)
    x = x + a
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "lnx")
    B, S, _ = h.shape
    hd = cfg.head_dim_r
    cdt = cfg.cdtype
    tp, hq, _ = _heads(cfg, "xattn")
    if tp > 1:
        h = copy_to_model(h)
    q = linear(p["xattn"], "wq", h, cfg.mac, cdt, tp).reshape(B, S, hq, hd)
    ek, ev = enc_kv
    zeros = torch.zeros((), dtype=torch.long, device=x.device)
    o = mha(q, ek, ev, local_kv_map(cfg, tp), scale=1.0 / math.sqrt(hd),
            q_pos=zeros.expand(S), k_pos=zeros.expand(ek.shape[1]),
            causal=False, chunk=cfg.attn_chunk)
    x = x + linear(p["xattn"], "wo", o.reshape(B, S, -1), cfg.mac, cdt, tp)
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln2")
    x = x + mlp_apply(p["mlp"], h, cfg.mac, cfg.act, cfg.gated_mlp, cdt,
                      splits(cfg)["mlp"])
    return x, new_cache, _zero(x)


def cross_kv(p_block, enc_out, cfg):
    """A decoder layer's cross-attention K/V (B, Se, n_kv, hd) from the
    encoder's output; under a mesh, this rank's kv heads."""
    B, Se, _ = enc_out.shape
    hd = cfg.head_dim_r
    tp, _, hkv = _heads(cfg, "xattn")
    if tp > 1:
        enc_out = copy_to_model(enc_out)
    k = linear(p_block["xattn"], "wk", enc_out, cfg.mac, cfg.cdtype, tp)
    v = linear(p_block["xattn"], "wv", enc_out, cfg.mac, cfg.cdtype, tp)
    return (k.reshape(B, Se, hkv, hd), v.reshape(B, Se, hkv, hd))
