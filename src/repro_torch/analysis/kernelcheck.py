"""Kernel-plan checker (the port's counterpart of
``repro/analysis/kernelcheck.py``, which evaluates the Pallas BlockSpec
index maps).

The port's CUDA kernels take their tiling from Python: kernel 1's
``plan``/``chunk_runs``/``chunk_uk`` (``kernels/encoded_matmul.py``) and
kernel 2's ``cluster_size``/``pages_used``/``block_pages``/``rank_pages``
/``warp_pages`` (``kernels/paged_attention.py``), handed to the C entry
points through ctypes.  This module proves on the CPU, before anything
runs on a card:

  * **kernel 1's chunks**: for every registry linear (k, n) (every arch,
    full width, with its TP 2 shards), every U in 1..``MAX_MONOS``, m in
    ``M_VALUES`` (m enters a plan only through ``tile_n``, so every
    tile) and SM counts ``SMS``: the (split, warp) chunk runs cover
    ``[0, chunks)`` once each without overlap, each inside its split's
    range, ``chunks = U · ceil(k / KC)``, and every chunk's (u, kc)
    lies inside U × ``ceil(k / KC)``, each pair once;
  * **kernel 1's limits**: ``1 ≤ splits ≤ MAX_SPLITS``, the C entry's
    own argument test holds, and ``smem ≤ SMEM_MAX``;
  * **kernel 2's pages**: for B in ``BATCHES``, every paged arch's kv
    heads (and a TP 2 rank's), page sizes 8 and 16, P in 1..``MAX_P``,
    Sq in 1, 5 and 9, the boundary lens (0, 1, ps−1, ps, ps+1, 2ps−1,
    P·ps−Sq) and ``SMS``: the ranks' runs and their warps' pages cover
    ``[0, pages_used)`` exactly once and read no page past it (nor past
    the table);
  * **kernel 2's cluster**: ``1 ≤ cluster ≤ MAX_CLUSTER``, the same for
    every lens of a shape and card; and no argument of a ``cluster_size``
    call in the wrapper names ``lens`` (an AST check of the source);
  * **constants**: each Python constant that mirrors a ``csrc``
    ``constexpr`` (``MIRRORS``) equals the value parsed from the ``.cu``;
  * **the launcher ABI**: each ctypes ``ARGTYPES`` (``LAUNCHERS``)
    matches its ``extern "C"`` signature in arity and in pointer / int /
    float kind, place by place, and returns ``int``.

A ``.cu`` line that no longer parses (a mirrored ``constexpr``, a
launcher's ``extern "C"``) is a finding, not a skip.  The check cores
take the plan functions, constants and sources as arguments so that the
self-test can pass mutated ones.
"""
from __future__ import annotations

import ast
import ctypes
import itertools
import math
import os
import re
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.analysis.lint import Finding, line_of, repo_root

RULE = "kernel-plan"
EM_REL = "src/repro_torch/kernels/encoded_matmul.py"
PA_REL = "src/repro_torch/kernels/paged_attention.py"
FA_REL = "src/repro_torch/kernels/flash_attention.py"
CSRC_REL = "src/repro_torch/csrc"

# a data row of a D x M serve runs its n_slots / D slots alone: kernel 1
# at m = n_slots / D (decode, draft) and (k + 1) · n_slots / D (verify),
# kernel 2 at B = n_slots / D (the chip smoke's serves: 4 slots, D = 2,
# k = 4)
DATA_ROW = dict(n_slots=4, n_data=2, spec_k=4)


def data_row_shapes(n_slots: int, n_data: int, spec_k: int) -> tuple:
    """((decode m, verify m), B) of a data row's split steps."""
    b = n_slots // n_data
    return (b, (spec_k + 1) * b), b


# m enters a plan only through tile_n (8, 16 or 32 rows) and the passes
# over m: each tile's edges, spec verification's 20 and 36, a data row's
# m, and the serves' larger ones (the static prefills 360, 884 and 4200)
M_VALUES = tuple(sorted({1, 4, 7, 8, 9, 15, 16, 17, 20, 31, 32, 33, 36, 64,
                         65, 360, 884, 4200}
                        | set(data_row_shapes(**DATA_ROW)[0])))
SMS = (132, 114, 78, 16)             # H100 SXM, H100 PCIe, and smaller
PAGE_SIZES = (8, 16)
SQ_VALUES = (1, 5, 9)                # decode, verify at k = 4 and 8
BATCHES = tuple(sorted({1, 2, 3, 4, 8, data_row_shapes(**DATA_ROW)[1]}))
MAX_P = 128                          # the serve's 127-page table and past

# Python constant → (its module, the .cu, the constexpr, a multiplier)
MIRRORS = (
    ("MAX_MONOS", EM_REL, "encoded_matmul.cu", "kMaxMonos", 1),
    ("KC", EM_REL, "encoded_matmul.cu", "kKC", 1),
    ("BN", EM_REL, "encoded_matmul.cu", "kBN", 1),
    ("WARPS", EM_REL, "encoded_matmul.cu", "kWarps", 1),
    ("STAGES", EM_REL, "encoded_matmul.cu", "kStages", 1),
    ("MAX_SPLITS", EM_REL, "encoded_matmul.cu", "kMaxSplits", 1),
    ("WARPS", PA_REL, "paged_attention.cu", "kWarps", 1),
    ("MAX_CLUSTER", PA_REL, "paged_attention.cu", "kMaxCluster", 1),
    ("MAX_ROW_BYTES", PA_REL, "paged_attention.cu", "kMaxPieces", 16),
    ("NEG_INF", PA_REL, "paged_attention.cu", "kNegInf", 1),
    ("NEG_INF", FA_REL, "flash_attention.cu", "kNegInf", 1),
    ("MAX_D", FA_REL, "flash_attention.cu", "kMaxD", 1),
)

# ctypes argtypes → (its module, attribute, the .cu, the C function)
LAUNCHERS = (
    (EM_REL, "ARGTYPES", "encoded_matmul.cu", "encoded_matmul_launch"),
    (PA_REL, "ARGTYPES", "paged_attention.cu", "paged_attn_launch"),
    (PA_REL, "FLOOR_ARGTYPES", "paged_attention.cu",
     "paged_attn_floor_launch"),
    (FA_REL, "ARGTYPES", "flash_attention.cu", "flash_attention_launch"),
)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _module(rel: str):
    import importlib
    name = rel[len("src/"):-len(".py")].replace("/", ".")
    return importlib.import_module(name)


# ---------------------------------------------------------------------------
# geometry from the registry
# ---------------------------------------------------------------------------

def linear_shapes(tp_values=(1, 2)) -> Dict[Tuple[int, int], List[str]]:
    """(k, n) of every 2-D linear weight (a ``w…`` leaf) of every registry
    arch at full width → the arches (and ``/tp2`` shards, ``/2x2`` a data
    row's) it comes from; a TP-servable arch's shards at each ``tp`` of
    ``tp_values``, and on a data row of ``DATA_ROW``'s data axis."""
    from repro_torch.analysis.shardcheck import (LayoutMesh, _arch_params,
                                                 leaf_paths,
                                                 serving_refusal)
    from repro_torch.configs import get_config, list_archs
    from repro_torch.parallel.sharding import shard_params
    out: Dict[Tuple[int, int], List[str]] = {}
    for arch in list_archs():
        cfg = get_config(arch)
        params = _arch_params(arch)
        trees = [(arch, params)]
        if serving_refusal(cfg) is None:
            D = DATA_ROW["n_data"]
            trees += [(f"{arch}/tp{tp}",
                       shard_params(params, cfg, LayoutMesh(tp)))
                      for tp in tp_values if tp > 1]
            trees += [(f"{arch}/{D}x{tp}",
                       shard_params(params, cfg, LayoutMesh(
                           tp, n_data=D, data_rank=D - 1)))
                      for tp in tp_values]
        for tag, tree in trees:
            for path, leaf in leaf_paths(tree):
                key = path.rsplit("/", 1)[-1]
                if leaf.dim() == 2 and key.startswith("w") and \
                        "table" not in path:
                    out.setdefault(tuple(leaf.shape), []).append(tag)
    return out


def paged_heads() -> Dict[int, List[str]]:
    """kv heads a kernel-2 call sees → the paged arches (and TP 2 ranks,
    and a 2 x 2 mesh's data row) it comes from."""
    from repro_torch.analysis.shardcheck import LayoutMesh, serving_refusal
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import supports_paged_cache
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import local_kv_heads
    out: Dict[int, List[str]] = {}
    for arch in list_archs():
        cfg = get_config(arch)
        if not supports_paged_cache(cfg):
            continue
        out.setdefault(cfg.n_kv_p, []).append(arch)
        if serving_refusal(cfg) is None:
            D = DATA_ROW["n_data"]
            for tag, mesh in (("tp2", LayoutMesh(2)),
                              (f"{D}x2", LayoutMesh(2, n_data=D,
                                                    data_rank=D - 1))):
                with set_mesh(mesh):
                    out.setdefault(local_kv_heads(cfg), []).append(
                        f"{arch}/{tag}")
    return out


# ---------------------------------------------------------------------------
# kernel 1
# ---------------------------------------------------------------------------

def check_kernel1(shapes, *, plan_fn: Optional[Callable] = None,
                  runs_fn: Optional[Callable] = None,
                  uk_fn: Optional[Callable] = None, U_values=None,
                  m_values=M_VALUES, sms=SMS, label: str = ""
                  ) -> Tuple[List[Finding], int]:
    """Kernel 1's plans over ``shapes`` (k, n) × U × m × SM counts;
    returns (findings, plans checked).  Defaults to the real functions
    and constants of ``kernels/encoded_matmul.py``."""
    import numpy as np
    from repro_torch.kernels import encoded_matmul as em
    plan_fn = plan_fn or em.plan
    runs_fn = runs_fn or em.chunk_runs
    uk_fn = uk_fn or em.chunk_uk
    U_values = U_values or range(1, em.MAX_MONOS + 1)
    loc = (EM_REL, line_of(EM_REL, r"^def plan\("))
    out: List[Finding] = []
    runs_seen: Dict[tuple, Optional[str]] = {}
    uk_seen = set()
    n_plans = 0
    for (k, n), U, s in itertools.product(shapes, U_values, sms):
        kcs = _cdiv(k, em.KC)
        for m in m_values:
            n_plans += 1
            p = plan_fn(m, k, n, U, s)
            ctx = f"{label} m={m} k={k} n={n} U={U} sms={s}: {p}"
            bad = []
            if p.chunks != U * kcs:
                bad.append(f"chunks {p.chunks} != U·ceil(k/KC) = {U * kcs}")
            if not 1 <= p.splits <= em.MAX_SPLITS:
                bad.append(f"splits {p.splits} outside 1..{em.MAX_SPLITS}")
            per = p.chunks_per_split
            if per < 1 or p.splits * per < p.chunks or \
                    (p.splits - 1) * per >= p.chunks:
                bad.append("the C entry refuses (splits, chunks_per_split)"
                           f" = ({p.splits}, {per}) for {p.chunks} chunks")
            if p.smem_bytes > em.SMEM_MAX:
                bad.append(f"smem {p.smem_bytes} B > SMEM_MAX {em.SMEM_MAX}")
            if p.tn < m and p.passes * p.tn < m:
                bad.append(f"{p.passes} passes of {p.tn} rows miss m={m}")
            key = (p.chunks, p.splits, per)
            if key not in runs_seen:
                runs_seen[key] = _runs_fault(runs_fn(p), p, em.WARPS)
            if runs_seen[key]:
                bad.append(runs_seen[key])
            if (U, k, p.chunks) not in uk_seen:
                uk_seen.add((U, k, p.chunks))
                j = np.arange(max(p.chunks, 0))
                u, kc = uk_fn(j, U)
                u, kc = np.asarray(u), np.asarray(kc)
                if len(j) and (u.min() < 0 or u.max() >= U or kc.min() < 0
                               or kc.max() >= kcs):
                    bad.append(f"a chunk's (u, kc) leaves {U} x {kcs}")
                elif len(np.unique(kc * U + u)) != len(j):
                    bad.append("two chunks map to one (u, kc)")
            for b in bad:
                out.append(Finding(RULE, loc[0], loc[1], f"{b} [{ctx}]"))
    return out, n_plans


def _runs_fault(runs, p, warps) -> Optional[str]:
    """Why the (split, warp) runs do not cover [0, chunks) once, each
    inside its split (None: they do)."""
    if len(runs) != p.splits * warps:
        return f"{len(runs)} runs for {p.splits} splits x {warps} warps"
    cover = sorted((b, e) for b, e in runs if e > b)
    at = 0
    for b, e in cover:
        if b != at:
            return (f"chunk runs {'overlap' if b < at else 'skip'} at "
                    f"{min(b, at)} (run [{b}, {e}))")
        at = e
    if at != p.chunks:
        return f"chunk runs end at {at}, not at chunks = {p.chunks}"
    for i, (b, e) in enumerate(runs):
        z = i // warps
        lo = z * p.chunks_per_split
        hi = min(p.chunks, lo + p.chunks_per_split)
        if e > b and (b < lo or e > hi):
            return f"run [{b}, {e}) of split {z} leaves its [{lo}, {hi})"
    return None


# ---------------------------------------------------------------------------
# kernel 2
# ---------------------------------------------------------------------------

def boundary_lens(ps: int, P: int, Sq: int) -> List[int]:
    top = P * ps - Sq                     # caller contract: lens + Sq <= P·ps
    vals = {0, 1, ps - 1, ps, ps + 1, 2 * ps - 1, top}
    return sorted(v for v in vals if 0 <= v <= top)


def real_kernel2_cluster(B, Hkv, P, sms, lens):
    """The wrapper's cluster for a call (``_paged_attn_kernel``)."""
    from repro_torch.kernels.paged_attention import cluster_size
    return cluster_size(B, Hkv, P, sms)


def check_kernel2(heads, *, cluster_fn: Optional[Callable] = None,
                  used_fn=None, bp_fn=None, rank_fn=None, warp_fn=None,
                  batches=BATCHES,
                  max_p: int = MAX_P, page_sizes=PAGE_SIZES,
                  sq_values=SQ_VALUES, sms=SMS, label: str = ""
                  ) -> Tuple[List[Finding], int]:
    """Kernel 2's launch plans over ``heads`` × B × P × page size × Sq ×
    boundary lens × SM counts; returns (findings, geometries checked).
    ``cluster_fn(B, Hkv, P, sms, lens)`` is the cluster a call launches
    (default: the wrapper's, ``real_kernel2_cluster``)."""
    from repro_torch.kernels import paged_attention as pa
    cluster_fn = cluster_fn or real_kernel2_cluster
    used_fn = used_fn or pa.pages_used
    bp_fn = bp_fn or pa.block_pages
    rank_fn = rank_fn or pa.rank_pages
    warp_fn = warp_fn or pa.warp_pages
    loc_cl = (PA_REL, line_of(PA_REL, r"^def cluster_size\("))
    loc_rk = (PA_REL, line_of(PA_REL, r"^def rank_pages\("))
    out: List[Finding] = []
    cover_seen: Dict[tuple, Optional[str]] = {}
    n = 0
    for Hkv, B, P, s in itertools.product(heads, batches,
                                          range(1, max_p + 1), sms):
        lens_sets = []
        for ps, sq in itertools.product(page_sizes, sq_values):
            for ln in boundary_lens(ps, P, sq):
                lens_sets.append((ps, sq, [ln] * B))
            mixed = boundary_lens(ps, P, sq)
            if mixed:
                lens_sets.append((ps, sq, [mixed[i % len(mixed)]
                                           for i in range(B)]))
        cls = {cluster_fn(B, Hkv, P, s, lens) for _, _, lens in lens_sets}
        ctx = f"{label} B={B} Hkv={Hkv} P={P} sms={s}"
        if len(cls) > 1:
            out.append(Finding(
                RULE, loc_cl[0], loc_cl[1],
                f"cluster size takes {sorted(cls)} over the lens of one "
                f"shape: it must come from the shape and the card only, "
                f"or a captured graph breaks when lens change [{ctx}]"))
        for cl in cls:
            if not 1 <= cl <= pa.MAX_CLUSTER:
                out.append(Finding(
                    RULE, loc_cl[0], loc_cl[1],
                    f"cluster {cl} outside 1..{pa.MAX_CLUSTER} [{ctx}]"))
        cl = min(cls)
        for ps, sq, lens in lens_sets:
            bp = bp_fn(ps)
            for ln in set(lens):
                n += 1
                nb = used_fn(ln, sq, ps)
                key = (nb, cl, bp, P)
                if key not in cover_seen:
                    cover_seen[key] = _pages_fault(nb, cl, bp, P, rank_fn,
                                                   warp_fn, pa.WARPS)
                if cover_seen[key]:
                    out.append(Finding(
                        RULE, loc_rk[0], loc_rk[1],
                        f"{cover_seen[key]} [{ctx} ps={ps} Sq={sq} "
                        f"lens={ln}: pages_used {nb}, cluster {cl}, "
                        f"block {bp}]"))
    return out, n


def _pages_fault(nb, cl, bp, P, rank_fn, warp_fn, warps) -> Optional[str]:
    if not 1 <= nb <= P:
        return f"pages_used {nb} outside 1..P = {P}"
    seen = []
    for z in range(cl):
        b, e = rank_fn(nb, cl, z, bp)
        for w in range(warps):
            seen.extend(warp_fn(b, e, w))
    past = [p for p in seen if p >= nb or p < 0]
    if past:
        return (f"a warp reads page {max(past)} past pages_used {nb}"
                if max(past) >= nb else f"a warp reads page {min(past)}")
    if sorted(seen) != list(range(nb)):
        dup = len(seen) - len(set(seen))
        return (f"pages read {dup} extra time(s)" if dup else
                f"{nb - len(set(seen))} page(s) of [0, {nb}) never read")
    return None


def check_cluster_call_sites(source: Optional[str] = None,
                             rel: str = PA_REL) -> List[Finding]:
    """No argument of a ``cluster_size(…)`` call names ``lens``."""
    if source is None:
        with open(os.path.join(repo_root(), rel), encoding="utf-8") as f:
            source = f.read()
    out = []
    n_calls = 0
    for node in ast.walk(ast.parse(source)):
        if not (isinstance(node, ast.Call) and (
                getattr(node.func, "id", None) == "cluster_size" or
                getattr(node.func, "attr", None) == "cluster_size")):
            continue
        n_calls += 1
        for arg in list(node.args) + [k.value for k in node.keywords]:
            names = {x.id for x in ast.walk(arg) if isinstance(x, ast.Name)}
            if "lens" in names:
                out.append(Finding(
                    RULE, rel, node.lineno,
                    f"cluster_size(...) takes '{ast.unparse(arg)}', which "
                    "reads lens: the cluster must come from the shape and "
                    "the card only"))
    if n_calls == 0:
        out.append(Finding(RULE, rel, 0,
                           "no cluster_size(...) call found to check"))
    return out


# ---------------------------------------------------------------------------
# constants and the launcher ABI
# ---------------------------------------------------------------------------

_CONSTEXPR_RE = re.compile(
    r"^\s*(?:static\s+)?constexpr\s+(?:int|float|double|size_t|unsigned)"
    r"\s+(\w+)\s*=\s*([^;]+);")


def cu_constants(text: str) -> Dict[str, float]:
    """name → value of each file-level ``constexpr`` scalar whose
    initializer is arithmetic over numbers and earlier constants."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        m = _CONSTEXPR_RE.match(line)
        if not m:
            continue
        expr = re.sub(r"(\d(?:\.\d*)?(?:e[+-]?\d+)?)[fFuUlL]+\b", r"\1",
                      m.group(2).strip())
        try:
            out[m.group(1)] = _eval(ast.parse(expr, mode="eval").body, out)
        except (SyntaxError, KeyError, ValueError, TypeError):
            continue
    return out


def _eval(node, env):
    if isinstance(node, ast.Constant) and isinstance(node.value,
                                                     (int, float)):
        return node.value
    if isinstance(node, ast.Name):
        return env[node.id]
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval(node.operand, env)
    if isinstance(node, ast.BinOp):
        a, b = _eval(node.left, env), _eval(node.right, env)
        ops = {ast.Add: a + b, ast.Sub: a - b, ast.Mult: a * b}
        if type(node.op) in ops:
            return ops[type(node.op)]
        if isinstance(node.op, ast.Div) and isinstance(a, int) and \
                isinstance(b, int):
            return a // b
    raise ValueError(ast.dump(node))


def check_constants(mirrors=MIRRORS, sources: Optional[dict] = None,
                    values: Optional[dict] = None
                    ) -> Tuple[List[Finding], List[dict]]:
    """Each mirrored constant against its ``constexpr``; returns
    (findings, one record per mirror).  ``sources``: {cu name: text}
    and ``values``: {(module rel, name): value} override the tree's."""
    out, report = [], []
    texts = dict(sources or {})
    for name, rel, cu, cname, mult in mirrors:
        if cu not in texts:
            with open(os.path.join(repo_root(), CSRC_REL, cu),
                      encoding="utf-8") as f:
                texts[cu] = f.read()
        py = (values or {}).get((rel, name), getattr(_module(rel), name))
        cvals = cu_constants(texts[cu])
        rec = {"python": f"{rel}:{name}", "cuda": f"{cu}:{cname}",
               "python_value": py}
        if cname not in cvals:
            out.append(Finding(
                RULE, f"{CSRC_REL}/{cu}", 0,
                f"constexpr {cname} (mirrored by {rel}:{name}) not found "
                "or does not parse"))
            rec["ok"] = False
            report.append(rec)
            continue
        want = cvals[cname] * mult
        rec["cuda_value"] = want
        ok = math.isclose(float(py), float(want), rel_tol=1e-6)
        rec["ok"] = ok
        if not ok:
            out.append(Finding(
                RULE, rel, line_of(rel, rf"^{name}\s*="),
                f"{name} = {py} but {cu}'s {cname}"
                f"{f' x {mult}' if mult != 1 else ''} = {want}"))
        report.append(rec)
    return out, report


_KIND = {ctypes.c_void_p: "pointer", ctypes.c_char_p: "pointer",
         ctypes.c_int: "int", ctypes.c_long: "int", ctypes.c_size_t: "int",
         ctypes.c_uint: "int", ctypes.c_float: "float",
         ctypes.c_double: "double"}


def c_signature(text: str, fn: str) -> Optional[Tuple[str, List[str]]]:
    """(return type, kinds of the parameters) of ``extern "C" … fn(…)`` in
    a CUDA source, or None where it is not found or does not parse."""
    m = re.search(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b' + re.escape(fn) +
                  r"\s*\(([^)]*)\)\s*\{", text)
    if m is None:
        return None
    params = [p.strip() for p in m.group(2).split(",") if p.strip()]
    kinds = []
    for p in params:
        p = re.sub(r"\s+", " ", p)
        if "*" in p:
            kinds.append("pointer")
        elif re.match(r"^(const )?(unsigned )?(int|long|size_t|int32_t|"
                      r"int64_t|uint32_t)\b", p):
            kinds.append("int")
        elif re.match(r"^(const )?float\b", p):
            kinds.append("float")
        elif re.match(r"^(const )?double\b", p):
            kinds.append("double")
        else:
            return None
    return m.group(1).strip(), kinds


def check_abi(launchers=LAUNCHERS, sources: Optional[dict] = None,
              argtypes: Optional[dict] = None
              ) -> Tuple[List[Finding], List[dict]]:
    """Each ctypes ``ARGTYPES`` against its ``extern "C"`` signature;
    returns (findings, one record per launcher).  ``argtypes``:
    {(module rel, attribute): tuple} overrides the tree's."""
    out, report = [], []
    texts = dict(sources or {})
    for rel, attr, cu, fn in launchers:
        if cu not in texts:
            with open(os.path.join(repo_root(), CSRC_REL, cu),
                      encoding="utf-8") as f:
                texts[cu] = f.read()
        types = (argtypes or {}).get((rel, attr),
                                     getattr(_module(rel), attr))
        py = [_KIND.get(t, t.__name__) for t in types]
        sig = c_signature(texts[cu], fn)
        rec = {"python": f"{rel}:{attr}", "cuda": f"{cu}:{fn}",
               "arity": len(py)}
        if sig is None:
            out.append(Finding(
                RULE, f"{CSRC_REL}/{cu}", 0,
                f'extern "C" {fn}(...) not found or does not parse'))
            rec["ok"] = False
            report.append(rec)
            continue
        ret, kinds = sig
        line = line_of(rel, rf"^{attr}\s*=")
        bad = []
        if ret != "int":
            bad.append(f"{fn} returns {ret}, the wrapper reads c_int")
        if len(kinds) != len(py):
            bad.append(f"{attr} has {len(py)} entries, {fn} takes "
                       f"{len(kinds)} arguments")
        for i, (a, b) in enumerate(zip(py, kinds)):
            if a != b:
                bad.append(f"{attr}[{i}] is {a}, {fn}'s argument {i} is a "
                           f"{b} (a pointer passed as c_int loses its "
                           "upper 32 bits)")
        for b in bad:
            out.append(Finding(RULE, rel, line, b))
        rec["ok"] = not bad
        report.append(rec)
    return out, report


def run_kernelcheck(sms=SMS) -> Tuple[List[Finding], Dict]:
    """The whole check: kernel 1 over every registry (k, n) and its TP 2
    shards, kernel 2 over every paged arch's heads, the mirrored
    constants, the launcher ABI and the cluster's call sites."""
    findings: List[Finding] = []
    shapes = linear_shapes()
    heads = paged_heads()
    f, n1 = check_kernel1(sorted(shapes), sms=sms)
    findings += f
    f, n2 = check_kernel2(sorted(heads), sms=sms)
    findings += f
    findings += check_cluster_call_sites()
    f, consts = check_constants()
    findings += f
    f, abi = check_abi()
    findings += f
    coverage = {
        "kernel1": {"linear_shapes": len(shapes),
                    "U": [1, 92], "m": [min(M_VALUES), max(M_VALUES)],
                    "data_row_m": list(data_row_shapes(**DATA_ROW)[0]),
                    "sms": list(sms), "plans": n1},
        "kernel2": {"kv_heads": {str(h): v for h, v in sorted(heads.items())},
                    "batches": list(BATCHES), "P": [1, MAX_P],
                    "data_row_B": data_row_shapes(**DATA_ROW)[1],
                    "page_sizes": list(PAGE_SIZES),
                    "sq": list(SQ_VALUES), "sms": list(sms),
                    "geometries": n2},
        "constants": consts,
        "launchers": abi,
    }
    return findings, coverage
