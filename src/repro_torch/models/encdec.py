"""Whisper-style encoder-decoder backbone (port of
``repro/models/encdec.py``).

The modality front end is a stub, as in the reference: ``enc_x`` is
precomputed frame embeddings (B, S_enc, d_model), S_enc = seq_len //
``cfg.enc_len_ratio``.  The encoder adds fixed sinusoidal positions; the
decoder reads a learned position table and ties its head to the token
embedding.

Params keep the reference's top-level leaves (``embed``, ``pos_table``,
``enc_norm_*``, ``final_norm_*``); the encoder's then the decoder's
per-layer dicts make the flat ``params["layers"]`` list (the reference's
stages ``"enc"`` and ``"dec"``, ``lm.layer_stages``).  A dense cache holds
per decoder layer the self-attention's ``k, v (B, max_len, n_kv, hd)``
and the cross-attention's ``ck, cv (B, S_enc, n_kv, hd)``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.nn import blocks as B
from repro_torch.nn.attention import init_kv_cache
from repro_torch.nn.common import (embed_init, norm_apply, norm_init,
                                   vocab_embed)
from repro_torch.parallel.sharding import local_kv_heads


def _sinusoid(S: int, d: int) -> np.ndarray:
    """The encoder's positions, in float64 then cast to f32, as the
    reference computes them."""
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    return np.concatenate([np.sin(ang), np.cos(ang)], -1).astype(np.float32)


def init_encdec(generator, cfg, place) -> dict:
    """Random params from ``generator``; ``place`` moves each layer to its
    device as it is made."""
    p = {"embed": embed_init(generator, cfg.vocab_p, cfg.d_model,
                             cfg.pdtype)}
    p["pos_table"] = (torch.randn((cfg.max_pos_embed, cfg.d_model),
                                  generator=generator, dtype=torch.float32)
                      * 0.01).to(cfg.pdtype)
    p["layers"] = [place(B.encoder_block_init(generator, cfg))
                   for _ in range(cfg.enc_layers)]
    p["layers"] += [place(B.xattn_decoder_block_init(generator, cfg))
                    for _ in range(cfg.dec_layers)]
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "enc_norm"))
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "final_norm"))
    return p


def _remat(cfg):
    # the reference's per-layer jax.checkpoint, where autograd records
    return cfg.remat and torch.is_grad_enabled()


def encode(params, cfg, enc_x):
    """Frames (B, S_enc, d) → the encoder's normed output."""
    Se = enc_x.shape[1]
    x = enc_x.to(cfg.cdtype) + torch.from_numpy(
        _sinusoid(Se, cfg.d_model)).to(enc_x.device, cfg.cdtype)
    for p_l in params["layers"][:cfg.enc_layers]:
        if _remat(cfg):
            x = checkpoint(B.encoder_block_apply, p_l, x, cfg,
                           use_reentrant=False)
        else:
            x = B.encoder_block_apply(p_l, x, cfg)
    return norm_apply(params, x, cfg.norm, cfg.norm_eps, "enc_norm")


def _dec_layer(p_l, x, enc_out, cfg, positions):
    x, _, _ = B.xattn_decoder_block_apply(p_l, x, B.cross_kv(p_l, enc_out,
                                                             cfg), cfg,
                                          positions=positions)
    return x


def apply_encdec(params, cfg, tokens, *, enc_x=None, cache=None):
    """tokens (B, S) → (the decoder's final-normed hidden state (B, S, d),
    new cache or None); ``lm.apply_model`` applies the tied head.

    No cache: ``enc_x`` is required (the reference asserts so).  With a
    dense cache (``init_encdec_cache``): ``enc_x`` given runs the encoder
    and fills each layer's cross K/V (in place where the cache's
    ``ck/cv`` have its shape, else the new cache carries new tensors);
    without it the decoder reads the cache's cross K/V (zeros until a
    prefill fills them).  The self-attention's K/V are written in place;
    the new cache carries ``pos + S``."""
    S = tokens.shape[1]
    dev = tokens.device
    pos0 = 0 if cache is None else cache["pos"]
    x = vocab_embed(params["embed"], tokens, cfg)
    ptab = params["pos_table"].to(cfg.cdtype)
    # dynamic_slice_in_dim: the start clamps to [0, max_pos_embed - S]
    start = torch.clamp(torch.as_tensor(pos0, device=dev), 0,
                        cfg.max_pos_embed - S)
    ar = torch.arange(S, device=dev)
    x = x + ptab.index_select(0, start + ar)[None]
    positions = pos0 + ar
    dec = params["layers"][cfg.enc_layers:]
    new_cache = None
    if cache is None:
        if enc_x is None:       # the reference's assert, kept under -O
            raise AssertionError("enc-dec training needs encoder inputs")
        enc_out = encode(params, cfg, enc_x)
        for p_l in dec:
            if _remat(cfg):
                x = checkpoint(_dec_layer, p_l, x, enc_out, cfg, positions,
                               use_reentrant=False)
            else:
                x = _dec_layer(p_l, x, enc_out, cfg, positions)
    else:
        enc_out = None if enc_x is None else encode(params, cfg, enc_x)
        layers = []
        for p_l, c_l in zip(dec, cache["layers"]):
            ck, cv = c_l["ck"], c_l["cv"]
            if enc_out is not None:        # prefill: fill the cross K/V
                k, v = B.cross_kv(p_l, enc_out, cfg)
                if k.shape == ck.shape:
                    ck.copy_(k)
                    cv.copy_(v)
                else:
                    ck, cv = k, v
            x, _, _ = B.xattn_decoder_block_apply(
                p_l, x, (ck, cv), cfg,
                cache={"k": c_l["k"], "v": c_l["v"], "pos": pos0},
                positions=positions)
            layers.append({"k": c_l["k"], "v": c_l["v"], "ck": ck, "cv": cv})
        new_cache = {"layers": layers, "pos": pos0 + S}
    h = norm_apply(params, x, cfg.norm, cfg.norm_eps, "final_norm")
    return h, new_cache


def init_encdec_cache(cfg, batch: int, max_len: int, enc_len: int = None, *,
                      device) -> list:
    """Per decoder layer a dense ``{k, v}`` of ``max_len`` rows and zero
    cross K/V ``{ck, cv}`` of ``enc_len`` frames (default ``max(1, max_len
    // enc_len_ratio)``, the reference's), in the compute dtype; under a
    mesh, this rank's kv heads (``local_kv_heads``)."""
    enc_len = enc_len or max(1, max_len // cfg.enc_len_ratio)
    layers = init_kv_cache(cfg, batch, max_len, cfg.dec_layers,
                           device=device)
    shape = (batch, enc_len, local_kv_heads(cfg), cfg.head_dim_r)
    for c in layers:
        c["ck"] = torch.zeros(shape, dtype=cfg.cdtype, device=device)
        c["cv"] = torch.zeros(shape, dtype=cfg.cdtype, device=device)
    return layers
