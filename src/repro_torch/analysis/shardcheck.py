"""Sharding-coverage checker (port of ``repro/analysis/shardcheck.py``).

``parallel/sharding.py`` cuts a rank's serving params by role
(``LINEAR_ROLES`` → ``linear_dim``, ``splits``, ``shard_params``) and
``parallel/statesharding.py`` a train state's leaves; both replicate what
they do not cut.  Replication is right for small leaves (norms, scales)
but a silent memory bug for large ones: a linear whose role is missing
is copied whole onto every rank with no runtime error.  This checker
builds every TP-servable and TP-trainable registry arch's parameter tree
at full size on the ``meta`` device (shapes only, no storage) and lays it
out on a stand-in model axis of ``TP`` ranks and on a ``DATA x TP`` mesh
(``LayoutMesh``, no process group):

  * **param coverage**: every leaf of at least ``LARGE_LEAF`` elements is
    cut by ``shard_params`` or matches an entry of ``REPLICATE`` (a path
    pattern with its reason);
  * **pool coverage**: the paged pools (``pool_k``/``pool_v``) and their
    scale side pools (``scale_k``/``scale_v``) of every kv dtype, and the
    static engine's dense cache (whisper's cross K/V ``ck``/``cv`` too),
    hold ``Hkv / TP`` kv heads a rank where attention splits, every other
    dim whole; MLA's latent ``ckv``/``kr`` is whole on every model rank;
  * **fold-role consistency**: with folded leaves planted beside every
    roled linear (``_fw (U, k, n)``, ``_fb (n,)``, ``_as``, ``_ws``),
    ``shard_params`` cuts n of a column linear's ``_fw`` and its
    ``_fb``/``_b``, k of a row linear's ``_fw`` and keeps its biases and
    every scale whole, as ``LINEAR_ROLES`` says; and a train state's dims
    (``statesharding.param_dims`` on the stacked layout) are the serving
    cut dims one place on (the layer axis), each dividing by ``TP``;
  * **the data axis** (a ``DATA x TP`` mesh, a data row past the first):
    a rank's params are its ``1 x TP`` slices (the data axis replicates
    every param), the paged pools and scale rows hold the whole page
    count and the dense cache (every leaf ``SERVING_CACHE`` names: the
    self-attention's, whisper's cross K/V, MLA's latent) the data row's
    batch rows, as the serving rules of ``parallel/statesharding.py``
    say.

Arches that ``shard_params`` (or ``check_trainable``) refuses are listed
in the coverage as refused, with the reason, not reported as findings.
The check cores take the tree, the replicate list and the roles table as
arguments so that the self-test can plant a defect.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.lint import Finding, line_of

RULE = "shard-coverage"
LARGE_LEAF = 1_000_000           # elements; below this, replication is fine
TP = 2
DATA = 2                         # the data axis of the 2 x 2 coverage
FOLD_U = 8                       # planes of a planted folded leaf

SHARDING_REL = "src/repro_torch/parallel/sharding.py"
STATESHARDING_REL = "src/repro_torch/parallel/statesharding.py"
LM_REL = "src/repro_torch/models/lm.py"
ROLES_AT = r"^LINEAR_ROLES"           # where each file's findings point
DIMS_AT = r"^def _leaf_dim"
CACHE_AT = r"^SERVING_CACHE"
POOLS_AT = r"^def paged_cache_layout"

# large leaves that stay whole on every rank on purpose: path pattern →
# reason (each the reference's own rule, ``repro/parallel/sharding.py``
# ``_RULES``, but for the MTP head)
REPLICATE: Dict[str, str] = {
    r"mla/w(q_a|kv_a|kr)$": "MLA's low-rank down projections, whose "
    "latent feeds every head (the reference's (attn|mla)/w(q_a|kv_a|kr)$: "
    "no model dim)",
    r"moe/router/w$": "the router: every rank routes every token (the "
    "reference's moe/router/w$: no model dim)",
    r"pos_table$": "whisper's decoder position table, read every step "
    "(the reference's pos_table$: replicated)",
    r"^mtp/": "deepseek-v3's multi-token-prediction head, which serving "
    "never reads; its cut (the reference's mtp/proj/w$, mtp/.*head/w$) "
    "comes with training under a mesh (ROADMAP Queue A, item 1)",
}


@dataclasses.dataclass
class LayoutMesh:
    """A stand-in ``(n_data, n_model)`` mesh for laying out shapes: what
    ``splits``, ``shard_params``, ``paged_cache_layout`` and the serving
    cache rules read of a ``Mesh``, without a process group."""
    n_model: int
    model_rank: int = 0
    n_data: int = 1
    data_rank: int = 0

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def rank(self) -> int:
        return self.data_rank * self.n_model + self.model_rank


def meta_params(cfg) -> dict:
    """``cfg``'s parameter tree at full size on the meta device."""
    from repro_torch.models import init_model
    return init_model(cfg, device="meta")


@functools.lru_cache(maxsize=None)
def _arch_params(arch: str) -> dict:
    """A registry arch's full meta tree, built once (no storage)."""
    from repro_torch.configs import get_config
    return meta_params(get_config(arch))


def leaf_paths(tree, prefix: str = ""):
    """("a/b/0/c", leaf) of every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{prefix}/{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}/{i}" if prefix else str(i))
    elif tree is not None:
        yield prefix, tree


def serving_refusal(cfg) -> Optional[str]:
    """Why ``shard_params`` refuses ``cfg`` (None: it shards it)."""
    from repro_torch.parallel.sharding import shard_params
    try:
        shard_params(_arch_params(cfg.arch), cfg, LayoutMesh(TP))
    except (ValueError, NotImplementedError) as e:
        return str(e)
    return None


def training_refusal(cfg) -> Optional[str]:
    from repro_torch.parallel.statesharding import check_trainable
    try:
        check_trainable(cfg)
    except NotImplementedError as e:
        return str(e)
    return None


def check_param_coverage(arch: str, params=None, replicate=None,
                         tp: int = TP) -> List[Finding]:
    """Every large leaf of ``arch``'s full tree is cut by
    ``shard_params`` at ``tp`` ranks or matches ``replicate``."""
    from repro_torch.configs import get_config
    from repro_torch.parallel.sharding import shard_params
    cfg = get_config(arch)
    params = _arch_params(arch) if params is None else params
    table = REPLICATE if replicate is None else replicate
    local = dict(leaf_paths(shard_params(params, cfg, LayoutMesh(tp))))
    out: List[Finding] = []
    for path, leaf in leaf_paths(params):
        if leaf.numel() < LARGE_LEAF:
            continue
        mine = local.get(path)
        if mine is not None and tuple(mine.shape) != tuple(leaf.shape):
            continue                               # cut
        if any(re.search(p, path) for p in table):
            continue
        out.append(Finding(
            RULE, SHARDING_REL, line_of(SHARDING_REL, ROLES_AT),
            f"{arch}: param '{path}' {tuple(leaf.shape)} "
            f"({leaf.numel():,} elements) is not cut by shard_params and "
            "is on no replicate list: every rank holds it whole; give "
            "its linear a role (LINEAR_ROLES) or list it in REPLICATE "
            "with the reason"))
    return out


def check_pool_coverage(arch: str, tp: int = TP) -> List[Finding]:
    """Paged pools and scale pools of every kv dtype, and the dense cache,
    hold ``Hkv / tp`` kv heads a rank where attention splits."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, supports_paged_cache
    from repro_torch.models.lm import paged_cache_layout
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import splits
    from repro_torch.parallel.statesharding import SERVING_CACHE
    cfg = get_config(arch)
    mesh = LayoutMesh(tp)
    with set_mesh(mesh):
        sp = splits(cfg)
    out: List[Finding] = []
    if sp.get("attn", sp.get("mla")) == 1:
        return out
    if supports_paged_cache(cfg):
        for dt in ("bf16", "int8", "int4"):
            if dt == "int4" and cfg.head_dim_r % 2:
                continue
            qcfg = dataclasses.replace(cfg, kv_cache_dtype=dt)
            whole = paged_cache_layout(qcfg, 9, 8)[0]
            with set_mesh(mesh):
                mine = paged_cache_layout(qcfg, 9, 8)[0]
            quant = dt != "bf16"
            if quant != ({"scale_k", "scale_v"} <= set(whole)):
                out.append(Finding(
                    RULE, LM_REL, line_of(LM_REL, POOLS_AT),
                    f"{arch} kv_dtype={dt}: scale side pools "
                    f"{'missing' if quant else 'unexpected'}"))
            for name, (shape, _) in whole.items():
                if name not in ("pool_k", "pool_v", "scale_k", "scale_v"):
                    out.append(Finding(
                        RULE, STATESHARDING_REL,
                line_of(STATESHARDING_REL, DIMS_AT),
                        f"{arch} kv_dtype={dt}: paged leaf '{name}' has "
                        "no pool rule"))
                    continue
                out += _heads_cut(f"{arch} kv_dtype={dt} '{name}'",
                                  shape, mine[name][0], 2, tp)
    cache = init_cache(cfg, 2, 64, device="meta")
    with set_mesh(mesh):
        rank = init_cache(cfg, 2, 64, device="meta")
    mine = dict(leaf_paths(rank["layers"]))
    for path, leaf in leaf_paths(cache["layers"]):
        name = path.rsplit("/", 1)[-1]
        if name not in SERVING_CACHE:
            continue
        m_dim = SERVING_CACHE[name][1]
        # the dense and cross K/V's kv heads; MLA's latent whole
        out += _heads_cut(f"{arch} dense cache '{path}'",
                          tuple(leaf.shape), tuple(mine[path].shape),
                          m_dim, 1 if m_dim is None else tp)
    return out


def _heads_cut(what, whole, mine, axis, tp) -> List[Finding]:
    """``axis`` (None: no dim) of a cache leaf cut into ``tp``, every
    other dim whole."""
    want = tuple(s // tp if i == axis else s for i, s in enumerate(whole))
    if tuple(mine) == want:
        return []
    rule = (f"the kv-head axis ({axis}) must split over the model axis"
            if axis is not None else "it has no kv-head axis and stays "
            "whole on every model rank")
    return [Finding(RULE, STATESHARDING_REL,
                line_of(STATESHARDING_REL, DIMS_AT),
                    f"{what}: a rank holds {tuple(mine)} of {tuple(whole)}"
                    f"; {rule}: expected {want}")]


def check_data_axis(arch: str, tp: int = TP, n_data: int = DATA
                    ) -> List[Finding]:
    """On the last data row of a ``n_data x tp`` mesh: the params are the
    ``1 x tp`` slices, and the paged pools, their scale rows and the dense
    cache are the shapes ``local_cache_shape`` gives (the whole page
    count; the data row's batch rows)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, supports_paged_cache
    from repro_torch.models.lm import paged_cache_layout
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.statesharding import (SERVING_CACHE,
                                                    cache_rows,
                                                    local_cache_shape)
    cfg = get_config(arch)
    mesh = LayoutMesh(tp, n_data=n_data, data_rank=n_data - 1)
    at = (STATESHARDING_REL, line_of(STATESHARDING_REL, CACHE_AT))
    out: List[Finding] = []
    params = _arch_params(arch)
    row = dict(leaf_paths(shard_params(params, cfg, mesh)))
    for path, leaf in leaf_paths(shard_params(params, cfg, LayoutMesh(tp))):
        if tuple(row[path].shape) != tuple(leaf.shape):
            out.append(Finding(
                RULE, SHARDING_REL, line_of(SHARDING_REL, ROLES_AT),
                f"{arch} {n_data}x{tp}: param '{path}' is "
                f"{tuple(row[path].shape)} on a data row, "
                f"{tuple(leaf.shape)} at 1x{tp}: the data axis must "
                "replicate every param"))

    def compare(what, name, whole, mine):
        want = local_cache_shape(name, whole, cfg, mesh)
        if tuple(mine) != want:
            out.append(Finding(
                RULE, at[0], at[1],
                f"{arch} {n_data}x{tp} {what} '{name}': a rank holds "
                f"{tuple(mine)} of {tuple(whole)}; the serving rules say "
                f"{want}"))
    if supports_paged_cache(cfg):
        n_pages = 9
        lo, hi = cache_rows("pool_k", n_pages, mesh)
        with set_mesh(mesh):
            mine = paged_cache_layout(cfg, hi - lo, 8)[0]
        for name, (shape, _) in paged_cache_layout(cfg, n_pages, 8)[0].items():
            compare("paged pool", name, shape, mine[name][0])
    B = 2 * n_data
    lo, hi = cache_rows("k", B, mesh)
    with set_mesh(mesh):
        rank = dict(leaf_paths(init_cache(cfg, hi - lo, 64,
                                          device="meta")["layers"]))
    for path, leaf in leaf_paths(init_cache(cfg, B, 64,
                                            device="meta")["layers"]):
        name = path.rsplit("/", 1)[-1]
        if name in SERVING_CACHE:
            compare(f"dense cache '{path}'", name, tuple(leaf.shape),
                    tuple(rank[path].shape))
    return out


def plant_folds(params: dict, U: int = FOLD_U) -> dict:
    """``params`` with a folded linear's leaves beside every roled 2-D
    linear weight of a block or the head (``_fw (U, k, n)``, ``_fb (n,)``,
    ``_as``, ``_ws``), on the meta device."""
    import torch
    from repro_torch.parallel.sharding import LINEAR_ROLES

    def plant(node):
        if isinstance(node, list):
            return [plant(v) for v in node]
        if not isinstance(node, dict):
            return node
        out = {k: plant(v) for k, v in node.items()}
        for key, t in node.items():
            if key in LINEAR_ROLES and isinstance(t, torch.Tensor) and \
                    t.dim() == 2:
                k, n = t.shape
                meta = dict(device="meta")
                out[key + "_fw"] = torch.empty((U, k, n),
                                               dtype=torch.bfloat16, **meta)
                out[key + "_fb"] = torch.empty((n,), **meta)
                out[key + "_as"] = torch.empty((), **meta)
                out[key + "_ws"] = torch.empty((), **meta)
        return out
    return plant(params)


def _expected_dim(key: str, ndim: int, roles: dict):
    """(linear, its role, the dim ``roles`` says a shard cuts of linear
    leaf ``key``: None for none); (None, None, None) for no linear's."""
    for suffix, col, row in (("", ndim - 1, ndim - 2), ("_fw", 2, 1),
                             ("_fb", 0, None), ("_b", 0, None),
                             ("_as", None, None), ("_ws", None, None)):
        if suffix and not key.endswith(suffix):
            continue
        name = key[:len(key) - len(suffix)] if suffix else key
        if name not in roles:
            continue
        role = roles[name]
        return name, role, (col if role == "column" else
                            row if role == "row" else None)
    return None, None, None


def check_fold_roles(arch: str, roles=None, tp: int = TP
                     ) -> List[Finding]:
    """``shard_params`` cuts every folded and fp linear leaf of ``arch``
    on the dim ``roles`` (default ``LINEAR_ROLES``) gives it, where its
    part splits."""
    from repro_torch.configs import get_config
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import (LINEAR_ROLES, shard_params,
                                               splits)
    cfg = get_config(arch)
    roles = LINEAR_ROLES if roles is None else roles
    params = plant_folds(_arch_params(arch))
    mesh = LayoutMesh(tp)
    with set_mesh(mesh):
        sp = splits(cfg)
    local = dict(leaf_paths(shard_params(params, cfg, mesh)))
    out: List[Finding] = []
    for path, leaf in leaf_paths(params):
        parts = path.split("/")
        key = parts[-1]
        part = parts[2] if parts[0] == "layers" and len(parts) > 3 else (
            "head" if parts[0] == "lm_head" else None)
        if part == "moe" and len(parts) > 4 and parts[3] == "shared":
            part = "shared"
        if part is None or sp.get(part, 1) == 1:
            continue
        name, role, want = _expected_dim(key, leaf.dim(), roles)
        if name is None:
            continue
        mine = tuple(local[path].shape)
        got = [i for i, (a, b) in enumerate(zip(leaf.shape, mine)) if a != b]
        want_l = [] if want is None else [want]
        if got != want_l:
            out.append(Finding(
                RULE, SHARDING_REL, line_of(SHARDING_REL, ROLES_AT),
                f"{arch}: '{path}' {tuple(leaf.shape)} is cut on dims "
                f"{got} ({mine} a rank), but its linear is {role}-"
                f"parallel: expected dims {want_l} (a column linear cuts n"
                " of (U, k, n) and its biases; a row linear cuts k and "
                "keeps its biases whole)"))
    return out


def check_train_dims(arch: str, tp: int = TP) -> List[Finding]:
    """A train state's dims (``param_dims`` on the stacked layout) are the
    serving cut dims one place on, and each divides by ``tp``."""
    from repro_torch.configs import get_config
    from repro_torch.models import stack_layers
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.statesharding import (REPLICATED, _paths,
                                                    param_dims)
    cfg = get_config(arch)
    params = _arch_params(arch)
    mesh = LayoutMesh(tp)
    serve = {}
    local = dict(leaf_paths(shard_params(params, cfg, mesh)))
    for path, leaf in leaf_paths(params):
        got = [i for i, (a, b) in enumerate(zip(leaf.shape,
                                                local[path].shape)) if a != b]
        parts = path.split("/")
        key = (parts[0],) + tuple(parts[2:]) if parts[0] == "layers" \
            else tuple(parts)
        serve.setdefault(key, (got[0] if got else None,
                               parts[0] == "layers"))
    stacked = stack_layers(params, cfg)
    dims = param_dims(stacked, cfg, mesh)
    out: List[Finding] = []
    for (path, leaf), d in zip(_paths(stacked), dims):
        if d != REPLICATED and leaf.shape[d] % tp:
            out.append(Finding(
                RULE, STATESHARDING_REL,
                line_of(STATESHARDING_REL, DIMS_AT),
                f"{arch}: train leaf '{'/'.join(map(str, path))}' "
                f"{tuple(leaf.shape)} is cut on dim {d}, which {tp} does "
                "not divide"))
        key = ("layers",) + tuple(map(str, path[1:])) \
            if path[0] in _STAGE_NAMES else tuple(map(str, path))
        want = serve.get(key)
        if want is None:
            continue
        s_dim, stacked_leaf = want
        want_d = REPLICATED if s_dim is None else s_dim + int(stacked_leaf)
        if d != want_d:
            out.append(Finding(
                RULE, STATESHARDING_REL,
                line_of(STATESHARDING_REL, DIMS_AT),
                f"{arch}: train leaf '{'/'.join(map(str, path))}' is cut "
                f"on dim {d}, serving cuts {s_dim} of its per-layer leaf "
                f"(expected {want_d})"))
    return out


_STAGE_NAMES = ("stack", "dense_prefix", "moe_stack")


def run_shardcheck() -> Tuple[List[Finding], Dict]:
    from repro_torch.configs import get_config, list_archs
    findings: List[Finding] = []
    served, trained, refused = [], [], {}
    for arch in list_archs():
        cfg = get_config(arch)
        why = serving_refusal(cfg)
        if why is not None:
            refused[arch] = why
            continue
        served.append(arch)
        findings += check_param_coverage(arch)
        findings += check_pool_coverage(arch)
        findings += check_fold_roles(arch)
        findings += check_data_axis(arch)
        if training_refusal(cfg) is None:
            trained.append(arch)
            findings += check_train_dims(arch)
        else:
            refused[f"{arch} (training)"] = training_refusal(cfg)
    coverage = {"tp": TP, "meshes": [f"1x{TP}", f"{DATA}x{TP}"],
                "served": served, "trained": trained,
                "refused": refused, "large_leaf_threshold": LARGE_LEAF,
                "replicate": dict(REPLICATE),
                "kv_dtypes": ["bf16", "int8", "int4"]}
    return findings, coverage
