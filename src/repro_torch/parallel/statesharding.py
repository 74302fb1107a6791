"""A train state's shards under a ``(data, model)`` mesh (port of
``repro/parallel/statesharding.py:opt_state_specs`` and of the param
rules of ``repro/parallel/sharding.py:param_specs`` on the stacked
``(L, …)`` layout).

Each leaf is either replicated or cut into equal shards along one dim by
the model axis; the data axis replicates everything (no FSDP: every
registered config has ``fsdp=False``).  The dims follow the serving
slices of ``sharding.shard_params`` so the model code reads a train
state's params as it reads a rank's serving params:

  * column linears (``wq wk wv wi wg`` and the untied head ``w``): the
    weight and its bias ``_b`` on their last dim;
  * row linears (``wo``): the weight on its k dim; the bias replicated
    (added once after the sum);
  * MoE expert stacks on their expert dim (EP), the router replicated;
  * the embedding table on its vocab rows where the head splits (the
    reference's ``embed/table`` rule); the lookup then reduces over the
    model axis and the tied head reads its rows;
  * norms, scales (``_s``, ``_as``), scalars: replicated.

A part that its dim does not let the axis divide runs replicated, as in
serving.  The optimizer state mirrors the params: AdamW's ``m``/``v``
leaf for leaf; Adafactor's ``vr``/``vc`` the matching dims of their
leaf; ``t`` and ``step`` replicated; the error-feedback buffers ``err``
like the params.  ``shard_state`` cuts a logical state, ``gather_state``
puts the logical one back together (a checkpoint is mesh-agnostic).

Serving's caches follow the reference's cache rules
(``repro/parallel/statesharding.py:_CACHE_RULES`` :79-101), stated once
in ``SERVING_CACHE`` and read by the engines and the shard checker
through ``cache_rows`` and ``local_cache_shape``: the paged pools and
their scale rows hold the whole page count on every data row, the static
engine's dense cache (whisper's cross K/V and MLA's latent too) the
data row's batch rows; all but the latent hold the model axis's kv heads
where attention splits.
"""
from __future__ import annotations

from repro_torch.tree import tree_flatten, tree_unflatten
from .mesh import set_mesh
from .sharding import attn_split, batch_rows, linear_dim, splits

# a leaf's dim in a dims list: replicated over the model axis
REPLICATED = -1
_STAGES = ("dense_prefix", "moe_stack", "stack")
TRAIN_TODO = ("training under a mesh covers the dense and GQA moe "
              "families; {arch!r} waits for ROADMAP Queue A, item 1 "
              "(training for the other five families, MTP included)")


# a serving cache leaf's name → (its dim over the data axis, its kv-head
# dim over the model axis); None: whole on every row
SERVING_CACHE = {
    # the static engine's dense cache (B, S, Hkv, D): the reference's
    # ``"k"``/``"v"`` rows over data
    "k": (0, 2), "v": (0, 2),
    # whisper's cross K/V (B, S_enc, Hkv, D): as ``k``/``v`` (the reference
    # cuts them over the frames instead, ``_CACHE_RULES["ck"]``)
    "ck": (0, 2), "cv": (0, 2),
    # MLA's latent (B, S, r) and rotated key (B, S, rope_dim): the data
    # row's batch rows, whole on every model rank (no head axis; the
    # reference cuts them over the sequence, ``_CACHE_RULES["ckv"]``)
    "ckv": (0, None), "kr": (0, None),
    # paged pools (P, ps, Hkv, D) and scale rows (P, ps, Hkv): no data
    # axis in the reference's ``pool_*``/``scale_*`` rules
    "pool_k": (None, 2), "pool_v": (None, 2),
    "scale_k": (None, 2), "scale_v": (None, 2),
}


def cache_rows(name: str, n: int, mesh) -> tuple:
    """The rows ``[lo, hi)`` of serving cache leaf ``name``'s first dim
    (``n`` long) that this rank holds under ``mesh``: the data row's batch
    rows (``sharding.batch_rows``) where the leaf's rule puts that dim over
    data, else all ``n``."""
    if SERVING_CACHE[name][0] != 0:
        return 0, n
    return batch_rows(n, mesh)


def local_cache_shape(name: str, shape: tuple, cfg, mesh) -> tuple:
    """The shape a rank of ``mesh`` holds of serving cache leaf ``name``
    of logical ``shape``, by ``SERVING_CACHE``: its data dim cut to the
    data row's rows, its kv heads (where it has them) cut where attention
    splits (``cfg``)."""
    d_dim, m_dim = SERVING_CACHE[name]
    out = list(shape)
    if d_dim is not None:
        lo, hi = batch_rows(shape[d_dim], mesh)
        out[d_dim] = hi - lo
    if m_dim is not None:
        with set_mesh(mesh):
            out[m_dim] //= attn_split(cfg)
    return tuple(out)


def check_trainable(cfg) -> None:
    """Raise where the port does not train ``cfg`` under ``mesh``."""
    if cfg.family not in ("dense", "moe") or cfg.use_mla or cfg.mtp:
        raise NotImplementedError(TRAIN_TODO.format(arch=cfg.arch))


def _paths(tree, prefix=()):
    """(path, leaf) in ``tree_flatten`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _linear_dim(key: str, ndim: int) -> int:
    d = linear_dim(key, ndim)
    return REPLICATED if d is None else d


def _leaf_dim(path: tuple, ndim: int, sp: dict) -> int:
    if path == ("embed", "table"):
        return 0 if sp["head"] > 1 else REPLICATED
    if path[0] == "lm_head":
        return _linear_dim(path[-1], ndim) if sp["head"] > 1 else REPLICATED
    if path[0] not in _STAGES or len(path) < 3:
        return REPLICATED
    part = path[1]
    if part == "moe":
        if path[2].startswith("experts_"):
            return 1 if sp["experts"] > 1 else REPLICATED
        if path[2] != "shared":
            return REPLICATED              # the router
        part = "shared"
    if part not in ("attn", "mlp", "shared") or sp.get(part, 1) == 1:
        return REPLICATED
    return _linear_dim(path[-1], ndim)


def param_dims(params: dict, cfg, mesh) -> list:
    """The model axis's dim of each leaf of the stacked params, logical
    or a rank's shards (``tree_flatten`` order), ``REPLICATED`` where
    none."""
    check_trainable(cfg)
    with set_mesh(mesh):
        sp = splits(cfg)
    return [_leaf_dim(path, t.dim(), sp) for path, t in _paths(params)]


def _factored_dims(d: int, ndim: int) -> dict:
    """Adafactor's ``vr`` (the leaf without its last dim) and ``vc`` (the
    leaf without its second-to-last dim) dims for a leaf cut on ``d``."""
    if d == REPLICATED:
        return {"vc": REPLICATED, "vr": REPLICATED}
    return {"vr": d if d < ndim - 1 else REPLICATED,
            "vc": d if d < ndim - 2 else
            (ndim - 2 if d == ndim - 1 else REPLICATED)}


def state_dims(state: dict, pdims: list) -> list:
    """The dims of every leaf of a train state ``{"params"[, "opt",
    "step", "err"]}`` (``tree_flatten`` order) from its params' dims."""
    p_leaves, p_spec = tree_flatten(state["params"])
    like = tree_unflatten(p_spec, pdims)
    dims = {"params": like}
    opt = state.get("opt")
    if opt is None:
        pass
    elif "f" in opt:                               # adafactor
        fs = tuple(_factored_dims(d, p.dim()) if "vr" in f
                   else {"v": d}
                   for f, d, p in zip(opt["f"], pdims, p_leaves))
        dims["opt"] = {"f": fs, "t": REPLICATED}
    elif "v" in opt:                               # adamw
        dims["opt"] = {"m": like, "t": REPLICATED, "v": like}
    else:                                          # sgd
        dims["opt"] = {"m": like}
    if "step" in state:
        dims["step"] = REPLICATED
    if "err" in state:
        dims["err"] = like
    leaves, spec = tree_flatten(dims)
    if spec != tree_flatten(state)[1]:
        raise ValueError("the train state's structure is not its params' "
                         "and optimizer's")
    return leaves


def shard_state(state: dict, cfg, mesh) -> dict:
    """This rank's shards of a logical train state (copies; replicated
    leaves shared with ``state``)."""
    dims = state_dims(state, param_dims(state["params"], cfg, mesh))
    leaves, spec = tree_flatten(state)
    n, r = mesh.n_model, mesh.model_rank
    out = []
    for t, d in zip(leaves, dims):
        if d != REPLICATED:
            k = t.shape[d] // n
            t = t.narrow(d, r * k, k).clone()
        out.append(t)
    return tree_unflatten(spec, out)


def gather_state(state: dict, cfg, mesh, device=None) -> dict:
    """The logical train state from every rank's shards (every rank
    calls it, in the same order), on ``device`` (default: the leaves'):
    a sharded leaf is its shards side by side (``Mesh.gather_columns``,
    exact)."""
    leaves, spec = tree_flatten(state)
    # the rules read paths and ranks only, which shards share with the
    # logical leaves
    dims = state_dims(state, param_dims(state["params"], cfg, mesh))
    out = []
    for t, d in zip(leaves, dims):
        if device is not None:
            t = t.to(device)
        if d != REPLICATED:
            t = mesh.gather_columns(t, d)
        out.append(t)
    return tree_unflatten(spec, out)
