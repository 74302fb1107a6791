"""Decoder-only LM, dense family (port of ``repro/models/lm.py``).

Params are a nested dict of tensors with the reference's leaf names; the
layer stack is a list of per-layer dicts under ``"layers"`` (the reference
stacks them ``(L, …)`` under ``"stack"`` for its scan).

Public API:
  init_model(cfg, *, seed, device)               → params
  apply_model(params, cfg, tokens, cache=None)   → (logits, new_cache)
  init_paged_cache(cfg, n_pages, page_size, *, device) → paged cache
  params_from_jax(tree, cfg, device)             → params
  to_device(params, device)                      → params
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.macexec import mm
from repro_torch.device import resolve_device
from repro_torch.nn import blocks as B
from repro_torch.nn.common import (embed_apply, embed_init, linear,
                                   linear_init, norm_apply, norm_init,
                                   softcap)
from repro_torch.quant.kvcache import kv_pool_layout


def init_model(cfg, *, seed: int = 0, device=None) -> dict:
    """Random params from ``seed``, made on the CPU (so every device gets
    the same numbers) and moved to ``device`` (default: the card)."""
    dev = resolve_device(device)
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP: remaining archs)")
    if cfg.mac.executor.requires_prepared_params:
        raise ValueError(
            f"init_model cannot initialize mac mode {cfg.mac.mode!r}; init "
            "in 'fp' mode and transform via "
            "serve.encoded.prepare_encoded_serving")
    gen = torch.Generator().manual_seed(seed)
    p = {"embed": embed_init(gen, cfg.vocab_p, cfg.d_model, cfg.pdtype)}
    p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "final_norm"))
    if not cfg.tie_embeddings:
        p["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_p, "w",
                                   cfg.mac, False, cfg.pdtype)
    p["layers"] = [B.decoder_block_init(gen, cfg)
                   for _ in range(cfg.n_layers)]
    return to_device(p, dev)


def to_device(tree, device):
    """A param tree (nested dicts / lists of tensors) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


def apply_model(params, cfg, tokens: torch.Tensor, *, cache=None):
    """tokens (B, S) → (logits (B, S, vocab_p), new_cache).

    ``cache``: None, or a paged cache ``{"layers": [{pool_k, pool_v[,
    scale_k, scale_v]}, …],
    "pages": (B, P) int32, "lens": (B,) int32}``.  The pools are written in
    place; the returned cache shares them and carries ``lens + S``."""
    Bn, S = tokens.shape
    x = embed_apply(params["embed"], tokens, cfg.cdtype)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=cfg.cdtype,
                             device=x.device)
    if cache is not None:
        lens = cache["lens"]
        positions = lens[:, None] + torch.arange(S, device=x.device,
                                                 dtype=lens.dtype)[None, :]
    else:
        positions = torch.arange(S, device=x.device)
    windows = cfg.layer_windows
    for i, p_l in enumerate(params["layers"]):
        c_l = None
        if cache is not None:
            c_l = dict(cache["layers"][i], pages=cache["pages"],
                       lens=cache["lens"])
        x, _ = B.decoder_block_apply(p_l, x, cfg, window=windows[i],
                                     cache=c_l, positions=positions)
    h = norm_apply(params, x, cfg.norm, cfg.norm_eps, "final_norm")
    logits = _head(params, cfg, h)
    new_cache = None
    if cache is not None:
        new_cache = {"layers": cache["layers"], "pages": cache["pages"],
                     "lens": cache["lens"] + S}
    return logits, new_cache


def _head(params, cfg, h):
    # the tied head reads the embedding table and stays an fp product in
    # every MAC mode; an untied lm_head is a normal 'w' linear
    if cfg.tie_embeddings:
        logits = mm(h, params["embed"]["table"].t(), cfg.cdtype)
    else:
        logits = linear(params["lm_head"], "w", h, cfg.mac, cfg.cdtype)
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    return logits.to(cfg.cdtype)


def supports_paged_cache(cfg) -> bool:
    """Block paging needs plain per-layer (k, v) attention: the dense
    family."""
    return cfg.family == "dense"


def init_paged_cache(cfg, n_pages: int, page_size: int, *, device=None):
    """Per layer a pool of fixed-size pages, ``pool_k/pool_v (n_pages,
    page_size, n_kv, hd)`` in the compute dtype; page 0 is scratch.

    With ``cfg.kv_cache_dtype`` 'int8'/'int4' the pools store quantized
    pages (int4 packs two head dims per byte) plus f32 per-token
    per-kv-head ``scale_k/scale_v (n_pages, page_size, n_kv)`` side
    pools."""
    dev = resolve_device(device)
    if not supports_paged_cache(cfg):
        raise ValueError(f"paged KV cache unsupported for arch {cfg.arch!r}")
    pdt, phd, quant = kv_pool_layout(cfg)
    shape = (n_pages, page_size, cfg.n_kv_p, phd)
    layers = []
    for _ in range(cfg.n_layers):
        st = {"pool_k": torch.zeros(shape, dtype=pdt, device=dev),
              "pool_v": torch.zeros(shape, dtype=pdt, device=dev)}
        if quant:
            for name in ("scale_k", "scale_v"):
                st[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                       device=dev)
        layers.append(st)
    return {"layers": layers}


# ---------------------------------------------------------------------------
# bridge from the reference's param tree
# ---------------------------------------------------------------------------

def _np_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _convert(tree, dev):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _convert(v, dev)
            continue
        t = _np_to_torch(v)
        if k.endswith("_fw"):
            # the port keeps folded bitplane weights in bf16 (the kernel's
            # operand type); the reference rounds its f32 fold to bf16 with
            # the same round-to-nearest-even at every call
            t = t.to(torch.bfloat16)
        out[k] = t.to(dev)
    return out


def _slice(tree, i):
    return {k: _slice(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def params_from_jax(tree, cfg, device=None) -> dict:
    """The reference's param tree (numpy leaves; stacked ``(L, …)`` leaves
    under ``"stack"``) → the port's params on ``device``, every leaf as is
    except folded ``*_fw`` tensors, which become bf16.  Carries the
    ``encoded_infer`` leaves ``*_fw/_fb/_as/_ws`` too."""
    dev = resolve_device(device)
    rest = {k: v for k, v in tree.items() if k != "stack"}
    params = _convert(rest, dev)
    params["layers"] = [_convert(_slice(tree["stack"], i), dev)
                        for i in range(cfg.n_layers)]
    return params
