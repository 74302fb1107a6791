"""Decoder-only LMs of the dense, moe, vlm, hybrid and xlstm families and
the encdec dispatch (port of ``repro/models/lm.py``).

Params are a nested dict of tensors with the reference's leaf names; the
layers of every stage are one flat list of per-layer dicts under
``"layers"``, in the order they run (the reference stacks each stage
``(L, …)`` under its own name for its scan: ``"stack"`` for the dense,
vlm and hybrid families; ``"dense_prefix"`` and ``"moe_stack"`` for the
moe family; ``"xlstm"``, itself ``{"mlstm": …, "slstm": …}``, for the
xlstm family; ``"enc"`` and ``"dec"`` for the encdec family,
``layer_stages``).  deepseek-v3's multi-token-prediction head sits under
``"mtp"``, hymba's meta tokens under ``"meta"``, whisper's decoder
position table under ``"pos_table"``, as in the reference.  A hybrid
layer nests its attention and SSM params under ``"attn"`` and ``"ssm"``,
and its cache holds ``{"attn": {k, v}, "ssm": {conv, h}}``; an xLSTM
layer's params and cache sit under ``"mlstm"`` or ``"slstm"``.  The
xLSTM layers run in the reference's scanned order: groups of
``n_mlstm // n_slstm`` mLSTM blocks, each followed by one sLSTM block.

Public API:
  init_model(cfg, *, seed, device, init_device)   → params
  apply_model(params, cfg, tokens, img=None, enc_x=None, cache=None)
                                                  → (logits, new_cache)
      (+ aux with return_aux, + hidden with return_hidden)
  mtp_logits(params, cfg, h, tokens)              → MTP logits
  init_cache(cfg, batch, max_len, *, device, enc_len) → dense cache
  reset_cache(layers)                             → a cache back to init
  init_paged_cache(cfg, n_pages, page_size, *, device) → paged cache
  supports_paged_cache(cfg) / supports_ragged_mask(cfg)
  layer_stages(cfg)                               → [(name, kind, n)]
  params_from_jax(tree, cfg, device)              → params
  train_state_from_jax(state, device)             → train state
  stack_layers(params, cfg) / unstack_layers(tree) ↔ the reference's stages
  to_reference_layout(tree, cfg) / from_reference_layout(tree)
  to_device(params, device)                       → params

The no-cache forward is differentiable end to end; with ``cfg.remat`` and
autograd on, each layer runs under ``torch.utils.checkpoint`` (the
reference's per-layer ``jax.checkpoint``), so only block inputs stay
alive between the forward and the backward.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.macexec import check_finite, mm
from repro_torch.device import resolve_device
from repro_torch.nn import blocks as B
from repro_torch.nn.attention import init_kv_cache
from repro_torch.nn.common import (embed_apply, embed_init, linear,
                                   linear_init, norm_apply, norm_init,
                                   softcap, vocab_embed)
from repro_torch.nn.mla import init_mla_cache
from repro_torch.nn.ssm import init_ssm_cache
from repro_torch.nn.xlstm import M_INIT, init_mlstm_cache, init_slstm_cache
from repro_torch.parallel.mesh import (copy_to_model, gather_from_model,
                                      get_mesh, set_mesh)
from repro_torch.parallel.sharding import local_kv_heads, splits
from repro_torch.quant.kvcache import kv_pool_layout
from repro_torch.tree import tree_leaves, tree_map
from .encdec import apply_encdec, init_encdec, init_encdec_cache

# the reference's stage names, in the order their layers run
STAGE_NAMES = ("dense_prefix", "moe_stack", "stack", "xlstm", "enc", "dec")
# the keys of a dense cache layer that hold a recurrent state (returned
# by a cached forward in new tensors, never written in place)
STATE_KEYS = ("ssm", "mlstm", "slstm")


def layer_stages(cfg) -> list:
    """(name, kind, n_layers) of each stage, as the reference's
    ``_stages``: the moe family's dense prefix (``first_k_dense``) and
    its MoE stack; the hybrid family's ``"stack"`` of hybrid blocks; the
    xlstm family's ``"xlstm"`` stage; the encdec family's encoder
    (``"enc"``) and decoder (``"dec"``); one dense ``"stack"`` for the
    dense and vlm families."""
    if cfg.family == "encdec":
        return [("enc", "encoder", cfg.enc_layers),
                ("dec", "xattn", cfg.dec_layers)]
    if cfg.family == "xlstm":
        return [("xlstm", "xlstm", cfg.n_layers)]
    if cfg.family == "moe":
        st = []
        if cfg.first_k_dense:
            st.append(("dense_prefix", "dense", cfg.first_k_dense))
        st.append(("moe_stack", "moe", cfg.n_layers - cfg.first_k_dense))
        return st
    if cfg.family == "hybrid":
        return [("stack", "hybrid", cfg.n_layers)]
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(f"unknown family {cfg.family!r}")
    return [("stack", "dense", cfg.n_layers)]


def _xlstm_order(n_m: int, n_s: int) -> list:
    """(sub-stack, index) of each xLSTM layer in run order: the
    reference's scanned order, groups of ``n_m // n_s`` mLSTM blocks each
    followed by one sLSTM block (all mLSTM without sLSTM blocks)."""
    if not n_s:
        return [("mlstm", i) for i in range(n_m)]
    per, rem = divmod(n_m, n_s)
    if rem:
        raise ValueError(f"{n_m} mLSTM blocks do not split into {n_s} "
                         "groups (the reference's scan cannot run them)")
    out = []
    for g in range(n_s):
        out += [("mlstm", g * per + j) for j in range(per)]
        out.append(("slstm", g))
    return out


def _xlstm_counts(cfg, n: int) -> tuple:
    n_s = n // cfg.slstm_every if cfg.slstm_every else 0
    return n - n_s, n_s


def layer_kinds(cfg) -> list:
    """Each layer's kind ('dense', 'moe', 'hybrid', 'mlstm', 'slstm',
    'encoder' or 'xattn'), in the order they run."""
    out = []
    for _, kind, n in layer_stages(cfg):
        if kind == "xlstm":
            out += [s for s, _ in _xlstm_order(*_xlstm_counts(cfg, n))]
        else:
            out += [kind] * n
    return out


_BLOCK_INIT = {"hybrid": B.hybrid_block_init, "mlstm": B.mlstm_block_init,
               "slstm": B.slstm_block_init}
_XLSTM_APPLY = {"mlstm": B.mlstm_block_apply, "slstm": B.slstm_block_apply}


def init_model(cfg, *, seed: int = 0, device=None, init_device="cpu"
               ) -> dict:
    """Random params from ``seed``, drawn on ``init_device`` and moved to
    ``device`` (default: the card).  The CPU draws by default, so every
    device gets the same numbers; a full-width model is drawn on the card
    in seconds (``init_device="cuda"``: other numbers from the same
    seed).  ``device="meta"`` gives the tree's shapes and dtypes without
    storage (``init_device`` is then ignored)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        init_device = "meta"
    kinds = layer_kinds(cfg)
    if cfg.mac.executor.requires_prepared_params:
        raise ValueError(
            f"init_model cannot initialize mac mode {cfg.mac.mode!r}; init "
            "in 'fp' mode and transform via "
            "serve.encoded.prepare_encoded_serving")
    # a meta tree draws nothing: any generator will do
    gen = torch.Generator(device="cpu" if init_device == "meta"
                          else init_device).manual_seed(seed)

    def place(layer):
        # a layer at a time to the device: a full-width model never sits
        # on the host whole
        if torch.device(init_device).type == "cpu":
            return to_device(layer, dev)
        return layer

    with torch.device(init_device):
        if cfg.family == "encdec":
            return to_device(init_encdec(gen, cfg, place), dev)
        p = {"embed": embed_init(gen, cfg.vocab_p, cfg.d_model, cfg.pdtype)}
        p.update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype, "final_norm"))
        if not cfg.tie_embeddings:
            p["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_p, "w",
                                       cfg.mac, False, cfg.pdtype)
        if cfg.meta_tokens:
            p["meta"] = (torch.randn((cfg.meta_tokens, cfg.d_model),
                                     generator=gen, dtype=torch.float32)
                         * 0.02).to(cfg.pdtype)
        p["layers"] = [place(_BLOCK_INIT[kind](gen, cfg)
                             if kind in _BLOCK_INIT else
                             B.decoder_block_init(gen, cfg, kind))
                       for kind in kinds]
        if cfg.mtp:
            p["mtp"] = {"proj": linear_init(gen, 2 * cfg.d_model,
                                            cfg.d_model, "w", cfg.mac,
                                            False, cfg.pdtype),
                        "block": B.decoder_block_init(gen, cfg, "dense")}
            p["mtp"].update(norm_init(cfg.d_model, cfg.norm, cfg.pdtype,
                                      "mtp_norm"))
    return to_device(p, dev)


def to_device(tree, device):
    """A tree of tensors (nested dicts, lists, tuples; ``None`` leaves, as
    in an optimizer's state) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if tree is None:
        return None
    return tree.to(device)


def apply_model(params, cfg, tokens: torch.Tensor, *, img=None, enc_x=None,
                cache=None, return_aux: bool = False,
                return_hidden: bool = False, local_logits: bool = False):
    """tokens (B, S) → (logits (B, S', vocab_p), new_cache[, aux][, h]);
    S' = S, plus ``cfg.meta_tokens`` where they are prepended.

    ``img`` (B, n_patches, d): a vlm's patch embeddings, which replace the
    leading ``min(n_patches, S)`` positions of the embedded prompt.  Meta
    tokens (hymba) lead the sequence in training and in a prefill (no
    cache, or S > 1 from position 0); a decode step finds them already in
    the cache.  ``enc_x`` (B, S_enc, d): an encdec arch's encoder frames
    (``models.encdec.apply_encdec``: required without a cache; with one,
    a prefill that fills the cross K/V).

    ``cache``: None; a paged cache ``{"layers": [{pool_k, pool_v[,
    scale_k, scale_v]}, …], "pages": (B, P) int32, "lens": (B,) int32}``;
    or a dense cache ``{"layers": [{k, v}, {ckv, kr}, {attn, ssm},
    {mlstm}, {slstm} or {k, v, ck, cv}, …], "pos"[, "pad"]}``
    (``init_cache``; ``pos`` an int or a 0-d tensor, ``pad`` (B,) the
    left-pad slots of each row).  The cache's tensors are written in
    place, except the recurrent states (``STATE_KEYS``: a hybrid layer's
    SSM state, an xLSTM layer's), which the returned cache carries as new
    tensors; the returned cache shares the rest and carries ``lens + S``
    (paged) or ``pos + S`` (dense).  ``return_aux`` adds the MoE layers'
    summed auxiliary loss (0-d f32), ``return_hidden`` the final normed
    hidden state (B, S, d) (the MTP head's input).

    Under a mesh whose model axis cuts the vocab, ``local_logits`` returns
    this rank's columns of the logits, ungathered (the trainer's
    vocab-parallel loss, ``train.losses.lm_loss_vocab_parallel``); a train
    state's embedding holds this rank's rows of the table (the
    reference's ``embed/table`` rule), which the lookup and the tied head
    read as such."""
    if cfg.family == "encdec":
        h, new_cache = apply_encdec(params, cfg, tokens, enc_x=enc_x,
                                    cache=cache)
        out = (_head(params, cfg, h), new_cache)
        if return_aux:
            out += (torch.zeros((), dtype=torch.float32, device=h.device),)
        if return_hidden:
            out += (h,)
        return out
    Bn, S = tokens.shape
    x = vocab_embed(params["embed"], tokens, cfg)
    if cfg.embed_scale:
        x = x * torch.full((), np.sqrt(cfg.d_model), dtype=cfg.cdtype,
                           device=x.device)
    if img is not None and cfg.n_patches:
        n_img = min(cfg.n_patches, S)          # patches lead the prompt
        x = torch.cat([img[:, :n_img].to(x.dtype), x[:, n_img:]], 1)
    if cfg.meta_tokens and (cache is None or S > 1):
        meta = params["meta"].to(x.dtype)[None].expand(
            Bn, cfg.meta_tokens, cfg.d_model)
        x = torch.cat([meta, x], 1)
        S = S + cfg.meta_tokens
    paged = cache is not None and "pages" in cache
    pad = cache.get("pad") if (cache is not None and not paged) else None
    ar = torch.arange(S, device=x.device)
    if paged:
        lens = cache["lens"]
        positions = lens[:, None] + ar.to(lens.dtype)[None, :]
        ctx = {"pages": cache["pages"], "lens": lens}
    elif cache is not None:
        pos = cache["pos"]
        ctx = {"pos": pos}
        if pad is not None:
            # left-padded ragged batch: row b's tokens start at pad[b]
            # slots, so its logical positions are slot - pad[b] (negative
            # for the pads themselves, whose keys attention masks)
            positions = pos + ar[None, :] - pad[:, None]
            ctx["pad"] = pad
        else:
            positions = pos + ar
    else:
        positions = ar
    windows = cfg.layer_windows
    kinds = layer_kinds(cfg)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = None if cache is None else list(cache["layers"])
    for i, p_l in enumerate(params["layers"]):
        if remat:
            x, a = checkpoint(_block, p_l, x, cfg, kinds[i], windows[i],
                              positions, get_mesh(), use_reentrant=False)
        elif kinds[i] == "hybrid":
            c_l = None if cache is None else {
                "attn": dict(layers[i]["attn"], **ctx),
                "ssm": layers[i]["ssm"]}
            x, c2, a = B.hybrid_block_apply(p_l, x, cfg, window=windows[i],
                                            cache=c_l, positions=positions)
            if c2 is not None:
                layers[i] = {"attn": layers[i]["attn"], "ssm": c2["ssm"]}
        elif kinds[i] in _XLSTM_APPLY:
            c_l = None if cache is None else layers[i][kinds[i]]
            x, c2, a = _XLSTM_APPLY[kinds[i]](p_l, x, cfg, cache=c_l)
            if c2 is not None:
                layers[i] = {kinds[i]: c2}
        else:
            c_l = None if cache is None else dict(layers[i], **ctx)
            x, _, a = B.decoder_block_apply(p_l, x, cfg, ffn=kinds[i],
                                            window=windows[i], cache=c_l,
                                            positions=positions)
        if kinds[i] == "moe":
            aux = aux + a
    h = norm_apply(params, x, cfg.norm, cfg.norm_eps, "final_norm")
    logits = _head(params, cfg, h, local_logits)
    new_cache = None
    if paged:
        new_cache = {"layers": cache["layers"], "pages": cache["pages"],
                     "lens": cache["lens"] + S}
    elif cache is not None:
        new_cache = {"layers": layers, "pos": cache["pos"] + S}
        if pad is not None:
            new_cache["pad"] = pad
    out = (logits, new_cache)
    if return_aux:
        out += (aux,)
    if return_hidden:
        out += (h,)
    return out


def _block(p_l, x, cfg, kind, window, positions, mesh=None):
    # under remat the backward recomputes this block on autograd's own
    # thread (a CUDA device's), where the active mesh (per thread) is
    # not set: enter the forward's mesh again
    with set_mesh(mesh):
        return _block_body(p_l, x, cfg, kind, window, positions)


def _block_body(p_l, x, cfg, kind, window, positions):
    if kind in _XLSTM_APPLY:
        x, _, aux = _XLSTM_APPLY[kind](p_l, x, cfg)
    elif kind == "hybrid":
        x, _, aux = B.hybrid_block_apply(p_l, x, cfg, window=window,
                                         positions=positions)
    else:
        x, _, aux = B.decoder_block_apply(p_l, x, cfg, ffn=kind,
                                          window=window, positions=positions)
    return x, aux


def _head(params, cfg, h, local_logits=False):
    # the tied head reads the embedding table and stays an fp product in
    # every MAC mode; an untied lm_head is a normal 'w' linear.  Under a
    # mesh the head is column-parallel (a tied one reads the rank's rows
    # of the table) and the logits are gathered on every rank unless
    # ``local_logits``
    tp = splits(cfg)["head"]
    if tp > 1:
        h = copy_to_model(h)
    if cfg.tie_embeddings:
        logits = mm(h, params["embed"]["table"].t(), cfg.cdtype)
    else:
        logits = linear(params["lm_head"], "w", h, cfg.mac, cfg.cdtype, tp)
    if tp > 1 and not local_logits:
        logits = gather_from_model(logits)
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    return check_finite(logits, "the LM head (logits)").to(cfg.cdtype)


def mtp_logits(params, cfg, h, tokens):
    """DeepSeek-style multi-token-prediction head: predicts token t+2 from
    (h_t, emb(t+1)) through one dense block.  Returns logits (B, S-1,
    vocab_p)."""
    e = embed_apply(params["embed"], tokens[:, 1:], cfg.cdtype)
    hin = torch.cat([h[:, :-1], e], dim=-1)
    x = linear(params["mtp"]["proj"], "w", hin, cfg.mac, cfg.cdtype)
    x, _, _ = B.decoder_block_apply(params["mtp"]["block"], x, cfg,
                                    ffn="dense", window=None)
    x = norm_apply(params["mtp"], x, cfg.norm, cfg.norm_eps, "mtp_norm")
    return _head(params, cfg, x)


def init_cache(cfg, batch: int, max_len: int, *, device=None,
               enc_len: int = None) -> dict:
    """Dense decode cache: per layer ``k/v (batch, max_len + meta_tokens,
    n_kv, hd)``, or with MLA the latent ``ckv (batch, max_len, r)`` and
    ``kr (batch, max_len, rope_dim)``, zeros in the compute dtype; a
    hybrid layer ``{"attn": {k, v}, "ssm": {conv, h}}``
    (``nn.ssm.init_ssm_cache``); an xLSTM layer ``{"mlstm": {C, n, m,
    conv}}`` or ``{"slstm": {h, c, m, n}}`` (``nn.xlstm``, m at
    ``M_INIT``); an encdec decoder layer ``{k, v, ck, cv}`` with
    ``enc_len`` cross frames (``models.encdec.init_encdec_cache``); and
    ``pos`` 0 (a 0-d int32 tensor)."""
    dev = resolve_device(device)
    kinds = layer_kinds(cfg)
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    if cfg.family == "encdec":
        return {"pos": pos, "layers": init_encdec_cache(
            cfg, batch, max_len, enc_len, device=dev)}
    if cfg.family == "xlstm":
        init = {"mlstm": init_mlstm_cache, "slstm": init_slstm_cache}
        return {"pos": pos, "layers": [
            {k: init[k](cfg, batch, 1, device=dev)[0]} for k in kinds]}
    max_len = max_len + cfg.meta_tokens
    if "hybrid" in kinds:
        att = init_kv_cache(cfg, batch, max_len, cfg.n_layers, device=dev)
        ssm = init_ssm_cache(cfg, batch, cfg.n_layers, device=dev)
        layers = [{"attn": a, "ssm": s_} for a, s_ in zip(att, ssm)]
    else:
        init = init_mla_cache if cfg.use_mla else init_kv_cache
        layers = init(cfg, batch, max_len, cfg.n_layers, device=dev)
    return {"pos": pos, "layers": layers}


def reset_cache(layers) -> None:
    """A dense cache's layers back to ``init_cache``'s values, in place:
    zeros, and ``M_INIT`` in the xLSTM states' stabilizer ``m``."""
    for layer in layers:
        for key, t in layer.items():
            if isinstance(t, dict):
                for k, leaf in t.items():
                    leaf.fill_(M_INIT if key in ("mlstm", "slstm")
                               and k == "m" else 0)
            else:
                t.zero_()


def supports_paged_cache(cfg) -> bool:
    """Block paging needs a plain per-layer (k, v) cache: dense/moe GQA
    attention without MLA latents, recurrent state, or meta tokens."""
    return (cfg.family in ("dense", "moe") and not cfg.use_mla
            and not cfg.meta_tokens)


def supports_ragged_mask(cfg) -> bool:
    """Whether left-pad masking (``pad_lens``) is exact for this arch:
    plain GQA attention over a dense cache (the paged predicate), and no
    flash prefill, whose summation order a solo run would not share.
    MLA latents, SSM state and meta tokens ingest the pads, which stay
    unmasked, as in the reference."""
    return supports_paged_cache(cfg) and not cfg.flash_attention


def paged_cache_layout(cfg, n_pages: int, page_size: int) -> list:
    """Per layer ``{name: (shape, dtype)}`` of the paged pools that
    ``init_paged_cache`` allocates (a drafter must match its verifier's);
    under a mesh, at this rank's kv heads (``local_kv_heads``)."""
    pdt, phd, quant = kv_pool_layout(cfg)
    shape = (n_pages, page_size, local_kv_heads(cfg), phd)
    st = {"pool_k": (shape, pdt), "pool_v": (shape, pdt)}
    if quant:
        for name in ("scale_k", "scale_v"):
            st[name] = (shape[:3], torch.float32)
    return [dict(st) for _ in range(cfg.n_layers)]


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
    return {"layers": [
        {name: torch.zeros(shape, dtype=dt, device=dev)
         for name, (shape, dt) in st.items()}
        for st in paged_cache_layout(cfg, n_pages, page_size)]}


# ---------------------------------------------------------------------------
# bridges to and from the reference's layout
# ---------------------------------------------------------------------------

def to_reference_layout(tree: dict, cfg) -> dict:
    """A tree in the port's layout (params, or a delta of folded leaves)
    in the reference's: the per-layer dicts under ``"layers"`` go to
    their stages (``layer_stages``; the xlstm stage's mLSTM and sLSTM
    layers to its ``"mlstm"`` and ``"slstm"`` sub-stacks), whose leaves
    are lists with one entry per layer (the reference's ``(L, …)`` arrays,
    to be stacked by whoever writes or hashes them); every other entry as
    is."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    if tree.get("layers"):
        kinds = layer_kinds(cfg)
        i = 0
        for name, kind, n in layer_stages(cfg):
            layers = tree["layers"][i:i + n]
            if kind == "xlstm":
                out[name] = {sub: _gather_layers(
                    [lay for lay, k in zip(layers, kinds[i:i + n])
                     if k == sub]) for sub in ("mlstm", "slstm")
                    if sub in kinds[i:i + n]}
            else:
                out[name] = _gather_layers(layers)
            i += n
    return out


def _gather_layers(layers: list) -> dict:
    return {k: _gather_layers([layer[k] for layer in layers])
            if isinstance(v, dict) else [layer[k] for layer in layers]
            for k, v in layers[0].items()}


def _run_order(name: str, stage) -> list:
    """(sub-stack key or None, index) of each layer of the reference stage
    ``name`` in run order (counts from the first leaf of each stack)."""
    if name == "xlstm":
        n = {k: len(tree_leaves(v)[0]) for k, v in stage.items()}
        return _xlstm_order(n.get("mlstm", 0), n.get("slstm", 0))
    return [(None, i) for i in range(len(tree_leaves(stage)[0]))]


def _stage_items(tree: dict):
    """(name, run order) of the reference stages in ``tree``, in run
    order."""
    for name in STAGE_NAMES:
        if name in tree:
            yield name, _run_order(name, tree[name])


def from_reference_layout(tree: dict) -> dict:
    """Inverse of ``to_reference_layout``: every stage's ``(L, …)``
    leaves become per-layer dicts of slices, one flat ``"layers"`` list in
    run order; every other entry as is."""
    out = {k: v for k, v in tree.items() if k not in STAGE_NAMES}
    layers = [_slice(tree[name] if sub is None else tree[name][sub], i)
              for name, order in _stage_items(tree) for sub, i in order]
    if layers:
        out["layers"] = layers
    return out


def _np_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _convert(tree, dev):
    if isinstance(tree, list):
        return [_convert(v, dev) for v in tree]
    out = {}
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            out[k] = _convert(v, dev)
            continue
        if k.endswith("_fw") and np.asarray(v).dtype == np.uint16:
            # the port's bundles store folded weights as bf16 bits
            t = torch.from_numpy(np.array(v, copy=True)).view(torch.bfloat16)
        else:
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


def tree_from_reference(tree: dict, device) -> dict:
    """A reference-layout tree of numpy leaves (params or a folded-leaf
    delta) → the port's layout as tensors on ``device``; folded ``*_fw``
    leaves become bf16 (from f32, or from the bf16 bits the port's
    bundles store as uint16)."""
    return _convert(from_reference_layout(tree), resolve_device(device))


def params_from_jax(tree, cfg, device=None) -> dict:
    """The reference's param tree (numpy leaves; stacked ``(L, …)`` leaves
    under its stage names) → the port's params for ``cfg`` on ``device``,
    every leaf as is except folded ``*_fw`` tensors, which become bf16.
    Carries the ``encoded_infer`` leaves ``*_fw/_fb/_as/_ws`` too."""
    want = [(name, n) for name, _, n in layer_stages(cfg)]
    got = [(name, len(order)) for name, order in _stage_items(tree)]
    if got != want:
        raise ValueError(f"the tree's stages {got} are not {cfg.arch}'s "
                         f"{want}")
    return tree_from_reference(tree, device)


def stack_layers(params: dict, cfg) -> dict:
    """The port's params in the reference's layout: the per-layer dicts
    under ``"layers"`` become the stages of ``cfg``, whose leaves are
    ``(L, …)`` tensors (``torch.stack``); every other entry as is.  The
    trainer keeps its state in this layout, so its optimizer state and
    checkpoints match the reference's leaf for leaf."""
    return _stack_lists(to_reference_layout(params, cfg))


def _stack_lists(tree):
    return {k: _stack_lists(v) if isinstance(v, dict) else
            (torch.stack(v) if isinstance(v, list) else v)
            for k, v in tree.items()}


def unstack_layers(tree: dict) -> dict:
    """Inverse of ``stack_layers``: per-layer views of every stage's
    ``(L, …)`` leaves (``unbind``, whose backward is one stack per leaf),
    one flat ``"layers"`` list in run order."""
    out = {k: v for k, v in tree.items() if k not in STAGE_NAMES}
    layers = []
    for name, order in _stage_items(tree):
        per_leaf = _unbind(tree[name])
        layers += [_pick(per_leaf if sub is None else per_leaf[sub], i)
                   for sub, i in order]
    if layers:
        out["layers"] = layers
    return out


def _unbind(tree):
    return {k: _unbind(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}


def _pick(tree, i):
    return {k: _pick(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def train_state_from_jax(state, device=None) -> dict:
    """The reference's train state (``init_train_state`` or a step's
    output, numpy leaves) → the port's train state on ``device``: the
    same tree, ``(L, …)`` layer stacks and optimizer state included, every
    leaf as is (``step``/``t`` int32 0-d tensors), so both packages start
    a step from the same numbers."""
    dev = resolve_device(device)
    return tree_map(lambda a: _np_to_torch(a).to(dev), state)
