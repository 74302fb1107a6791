"""Tensor-parallel roles, the model axis's split of each block, and each
rank's slices of the params (port of ``repro/parallel/sharding.py``:
``LINEAR_ROLES``/``linear_role`` :138-160, the path rules ``_RULES`` :161
and ``param_specs`` :254 with its divisibility fallback, and the pool
rules of ``repro/parallel/statesharding.py:78-113``).

Megatron-style, the math of the reference's GSPMD result:

  * column linears (``wq wk wv wi wg`` and the head ``w``): a rank holds
    the n-slice of the weight, of ``*_fw`` (U, k, n), ``*_fb`` and ``*_b``;
  * row linears (``wo``): a rank holds the k-slice of the weight and of
    ``*_fw``; its product runs with a zero bias, the partials are summed
    over the model axis, then the replicated ``*_fb``/``*_b`` is added
    once (``repro/kernels/ops.py:103-109``);
  * attention runs on a rank's ``Hq/TP`` and ``Hkv/TP`` heads, and the
    paged pools, their scale rows and the static engine's dense cache
    hold ``Hkv/TP`` heads a rank (the reference shards the dense cache
    over the sequence instead, ``_CACHE_RULES["k"]``); whisper's
    cross-attention likewise, its cross K/V ``ck``/``cv`` included;
  * MLA runs on a rank's ``H/TP`` heads (``wq_b``/``wk_b``/``wv_b``
    column, ``wo`` row); its latent cache ``ckv``/``kr`` has no head axis
    and stays whole on every model rank (the reference cuts it over the
    sequence, ``_CACHE_RULES["ckv"]``);
  * MoE experts split over the model axis (EP), the router is
    replicated, a shared expert follows the dense MLP;
  * the head is column-sharded and its logits are gathered on every
    rank; with it the embedding table is cut on its vocab rows (the
    reference's ``embed/table`` rule): the lookup sums the rows over the
    model axis (exact: one rank holds each token's row) and a tied head
    reads the rank's rows.

A block whose heads, or whose sharded dim, does not divide the model axis
runs replicated (``split``), the reference's per-dim ``ok()``.  A rank's
params come from ``shard_params``; the scales ``*_as``/``*_ws``/``*_s``,
norms and the router stay replicated.
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh import get_mesh, set_mesh

LINEAR_ROLES: dict = {
    "wq": "column", "wk": "column", "wv": "column", "wkv": "column",
    "wqkv": "column", "wq_b": "column", "wk_b": "column", "wv_b": "column",
    "wi": "column", "wg": "column", "win": "column", "wup": "column",
    "w": "column",                        # lm_head / untied output head
    "wo": "row", "wout": "row",
}


def linear_role(name: str) -> str:
    """Tensor-parallel role of linear param ``name``: 'column', 'row' or
    'replicated'."""
    return LINEAR_ROLES.get(name, "replicated")


def split(dim: int) -> int:
    """Shards the active mesh's model axis cuts a dim of ``dim`` into:
    the axis size where it divides ``dim``, else 1 (runs replicated); 1
    without a mesh."""
    mesh = get_mesh()
    if mesh is None or mesh.n_model == 1 or dim % mesh.n_model:
        return 1
    return mesh.n_model


def model_rank() -> int:
    mesh = get_mesh()
    return 0 if mesh is None else mesh.model_rank


def _kv_map(cfg) -> np.ndarray:
    from repro_torch.nn.attention import kv_of_q_map
    return kv_of_q_map(cfg.n_heads, cfg.n_kv_heads, cfg.n_heads_p,
                       cfg.n_kv_p)


def attn_split(cfg) -> int:
    """The model axis's split of a GQA attention block's heads: it must
    divide both head counts, and each rank's q heads must read only its
    own kv heads (else the block runs replicated)."""
    tp = split(cfg.n_kv_p)
    if tp == 1 or cfg.n_heads_p % tp:
        return 1
    hq, hkv = cfg.n_heads_p // tp, cfg.n_kv_p // tp
    kv = _kv_map(cfg)
    for r in range(tp):
        loc = kv[r * hq:(r + 1) * hq] - r * hkv
        if loc.min() < 0 or loc.max() >= hkv:
            return 1
    return tp


def local_kv_map(cfg, tp: int) -> np.ndarray:
    """This rank's q-head → kv-head map over its ``Hq/tp`` and ``Hkv/tp``
    heads (the whole map at ``tp = 1``)."""
    kv = _kv_map(cfg)
    if tp == 1:
        return kv
    r = model_rank()
    hq, hkv = cfg.n_heads_p // tp, cfg.n_kv_p // tp
    return (kv[r * hq:(r + 1) * hq] - r * hkv).astype(np.int32)


def local_kv_heads(cfg) -> int:
    """kv heads a rank's caches and pools hold."""
    return cfg.n_kv_p // attn_split(cfg)


def splits(cfg) -> dict:
    """Each sharded part of a block and the head → its split under the
    active mesh (1: replicated): GQA attention (``"attn"``; whisper's
    encoder and decoder self-attention, and its cross-attention
    ``"xattn"`` at the same split) or MLA (``"mla"``: its heads, which
    share one latent and have no kv-head map), the dense MLP, the
    experts and the shared expert."""
    out = {"head": split(cfg.vocab_p)}
    if cfg.use_mla:
        out["mla"] = split(cfg.n_heads_p)
    else:
        out["attn"] = attn_split(cfg)
    if cfg.family == "encdec":
        out["xattn"] = out["attn"]
    if cfg.n_experts:
        out["experts"] = split(cfg.n_experts)
        if cfg.n_shared_experts:
            out["shared"] = split(cfg.n_shared_experts * cfg.d_ff_expert)
    if not cfg.n_experts or cfg.first_k_dense:
        out["mlp"] = split(cfg.d_ff)
    return out


# ---------------------------------------------------------------------------
# each rank's slices of the params
# ---------------------------------------------------------------------------

def _slice(t: torch.Tensor, dim: int, tp: int, r: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    # a copy, so the full tensor can be freed
    return t.narrow(dim, r * n, n).clone()


def linear_dim(key: str, ndim: int):
    """The dim a tensor-parallel shard cuts of linear leaf ``key`` (of
    ``ndim`` dims): a column linear's weight, ``_fw`` (U, k, n), ``_fb``
    and ``_b`` on their last dim; a row linear's weight and ``_fw`` on
    their k dim; None for a row linear's biases, every scale and every
    other leaf."""
    for suffix in ("", "_fw", "_fb", "_b"):
        if suffix and not key.endswith(suffix):
            continue
        role = linear_role(key[:len(key) - len(suffix)] if suffix else key)
        if role == "column":
            return ndim - 1
        if role == "row" and suffix in ("", "_fw"):
            return ndim - 2
    return None


def _shard_linears(node: dict, tp: int, r: int) -> dict:
    """A block's dict with every roled linear's leaves cut to rank ``r``
    of ``tp`` (``linear_dim``)."""
    out = dict(node)
    for key, t in node.items():
        if isinstance(t, torch.Tensor):
            d = linear_dim(key, t.dim())
            if d is not None:
                out[key] = _slice(t, d, tp, r)
    return out


# the families ``shard_params`` cuts
SERVED_FAMILIES = ("dense", "moe", "vlm", "encdec")


class LocalParams(dict):
    """A rank's params as ``shard_params`` cut them; ``shard_params``
    returns one as it is, so several engines of a rank can share one
    copy of its slices while the whole params are freed."""


def shard_params(params: dict, cfg, mesh) -> dict:
    """This rank's serving params (a ``LocalParams``): every sharded leaf
    cut to its slice (a copy), every replicated one shared with
    ``params``.  The dense, moe (GQA or MLA), vlm and encdec families;
    the hybrid and xlstm families raise.  MLA's ``wq_b``/``wk_b``/``wv_b``
    are column linears and its ``wo`` a row linear, each cut on whole
    heads (the raw weights, which decode reads, as well as their folds);
    its low-rank down projections ``wq_a``/``wkv_a``/``wkr``, their norms,
    whisper's ``pos_table`` and the MTP head (which serving never reads)
    stay whole, as the reference's rules say.  The slices are the model
    axis's alone: a ``DxM`` mesh cuts them as ``1xM`` does and its data
    axis replicates every param (no FSDP, as the reference's serving).
    A train state's shards: ``statesharding.shard_state``."""
    if isinstance(params, LocalParams):
        return params
    if cfg.family not in SERVED_FAMILIES:
        raise ValueError(f"tensor-parallel serving covers the dense, moe, "
                         f"vlm and encdec families, not {cfg.arch!r} "
                         "(ROADMAP Queue A, item 1: hymba and xlstm)")
    with set_mesh(mesh):
        sp = splits(cfg)
    r = mesh.model_rank
    out = dict(params)
    if sp["head"] > 1:
        out["embed"] = dict(params["embed"],
                            table=_slice(params["embed"]["table"], 0,
                                         sp["head"], r))
        if not cfg.tie_embeddings:
            out["lm_head"] = _shard_linears(params["lm_head"], sp["head"],
                                            r)
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        for part in ("attn", "xattn", "mla"):
            if part in layer and sp.get(part, 1) > 1:
                layer[part] = _shard_linears(layer[part], sp[part], r)
        if "mlp" in layer and sp.get("mlp", 1) > 1:
            layer["mlp"] = _shard_linears(layer["mlp"], sp["mlp"], r)
        if "moe" in layer:
            moe = dict(layer["moe"])
            tp = sp["experts"]
            if tp > 1:
                for k in ("experts_wi", "experts_wg", "experts_wo"):
                    moe[k] = _slice(moe[k], 0, tp, r)
            if "shared" in moe and sp.get("shared", 1) > 1:
                moe["shared"] = _shard_linears(moe["shared"], sp["shared"],
                                               r)
            layer["moe"] = moe
        layers.append(layer)
    out["layers"] = layers
    return LocalParams(out)


def batch_rows(n: int, mesh) -> tuple:
    """This data row's rows ``[lo, hi)`` of a batch of ``n`` (the
    reference's ``batch_spec``): contiguous, ``n / D`` long where the data
    axis's ``D`` divides ``n``, else ``(0, n)``: the batch is replicated.
    ``(0, n)`` without a mesh."""
    D = 1 if mesh is None else mesh.n_data
    if D == 1 or n % D:
        return 0, n
    k = n // D
    return mesh.data_rank * k, (mesh.data_rank + 1) * k


def replicated_parts(cfg, mesh) -> list:
    """The parts of a block (and the head) that run replicated under
    ``mesh`` because their dim does not divide its model axis (none
    without a model axis)."""
    if mesh.n_model == 1:
        return []
    with set_mesh(mesh):
        return sorted(k for k, v in splits(cfg).items() if v == 1)
