"""Dense decoder block (port of the dense part of ``repro/nn/blocks.py``).
Every block is (init, apply) with apply(params, x, cfg, *, window, cache,
positions) → (x_out, new_cache)."""
from __future__ import annotations

from .attention import attn_apply, attn_init
from .common import mlp_apply, mlp_init, norm_apply, norm_init


def decoder_block_init(generator, cfg) -> dict:
    p = {"attn": attn_init(generator, cfg),
         "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mac,
                         cfg.gated_mlp, cfg.mlp_bias, cfg.pdtype)}
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln1"))
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln2"))
    if cfg.post_norm:
        p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln1p"))
        p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "ln2p"))
    return p


def decoder_block_apply(p, x, cfg, *, window=None, cache=None,
                        positions=None):
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln1")
    a, new_cache = attn_apply(p["attn"], h, cfg, window=window, cache=cache,
                              positions=positions)
    if cfg.post_norm:
        a = norm_apply(p, a, cfg.norm, cfg.norm_eps, "ln1p")
    x = x + a
    h = norm_apply(p, x, cfg.norm, cfg.norm_eps, "ln2")
    f = mlp_apply(p["mlp"], h, cfg.mac, cfg.act, cfg.gated_mlp, cfg.cdtype)
    if cfg.post_norm:
        f = norm_apply(p, f, cfg.norm, cfg.norm_eps, "ln2p")
    return x + f, new_cache
