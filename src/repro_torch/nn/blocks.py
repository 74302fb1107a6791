"""Decoder blocks of the dense, moe and hybrid families (port of the
dense/MoE and hybrid parts of ``repro/nn/blocks.py``): GQA attention or
MLA, then a dense MLP or a mixture of experts; or Hymba's attention and
SSM heads in parallel, then a dense MLP.  Every block is (init, apply)
with apply(params, x, cfg, *, window, cache, positions) → (x_out,
new_cache, aux), ``aux`` the router's auxiliary loss (0 for a dense MLP
and a hybrid block)."""
from __future__ import annotations

import torch

from .attention import attn_apply, attn_init
from .common import mlp_apply, mlp_init, norm_apply, norm_init
from .mla import mla_apply, mla_init
from .moe import moe_apply, moe_init
from .ssm import ssm_apply, ssm_init


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
                      cfg.cdtype)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
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
    return x + f, new_cache, torch.zeros((), dtype=torch.float32,
                                         device=x.device)
