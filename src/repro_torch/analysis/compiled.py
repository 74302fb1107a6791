"""Captured-step audit (the port's counterpart of
``repro/analysis/compiled.py``, which lowers the jitted serving steps and
reads their HLO).  The port has no HLO: it reads what its own steps
record, the CUDA graphs of ``serve/graphs.py`` and the mesh's
collective counters.  Four rules:

  * **recompile-count**: a fixed smoke trace (chunked prefill, decode, a
    speculative round and an eviction, ``run_smoke_trace``) costs exactly
    the captures per step kind that ``EXPECTED_CAPTURES`` pins, as the
    reference's ``EXPECTED_COMPILES``.  On the card each step is captured
    once (``Step.captures``); on the CPU, where nothing is captured, the
    count is the step's first binding of its input buffers
    (``Step.binds``), the call that captures on the card.
  * **compiled-donation**: the KV pools and their scale pools are updated
    in place: every pool tensor of ``kv.layers`` keeps its ``data_ptr``
    across steps (and replays), and the layers the steps are bound to are
    the cache's own.
  * **compiled-capture**: no weight-sized tensor is made while a step
    runs or is captured: every op's output is recorded
    (``AllocRecorder``, a ``TorchDispatchMode``); one that owns new
    storage of as many elements as a param leaf of at least
    ``LARGE_LEAF_NUMEL`` elements that the op reads (itself or through a
    view), at any dtype, is a copy of that weight (``fw.float()``, an f32
    dequantisation of int8, a transposed copy) that would live in the
    graph's memory pool.  A slice or a concatenation of weights has
    another count and is not seen by it.  On the card the graphs' own
    memory pools are also read from the allocator
    (``torch.cuda.memory_snapshot``) and held to ``GRAPH_POOL_MARGIN`` a
    graph: a copy that does not fit in the allocator's smallest segments
    shows there whatever its shape.
  * **compiled-collectives**: at TP 2, over two gloo ranks on the CPU
    (``parallel.mesh.run_ranks``), a decode step and a prefill chunk of
    reduced qwen1.5-0.5b make exactly the collectives by op kind that
    ``EXPECTED_COLLECTIVES`` pins (``Mesh.by_op``), no all-gather's
    payload is the size of a whole pool or a whole param leaf (a
    reassembled pool or folded ``fw``), and a single-rank step makes
    none.

The check cores take their expected tables and recorded runs as
arguments, so that ``analysis/selftest.py`` can plant each defect (a pool
copied instead of updated, a stray all-gather) without touching the
tree.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.lint import Finding, line_of

RULE_RECOMPILE = "recompile-count"
RULE_DONATION = "compiled-donation"
RULE_CAPTURE = "compiled-capture"
RULE_COLLECTIVES = "compiled-collectives"

ENGINE_REL = "src/repro_torch/serve/engine.py"
GRAPHS_REL = "src/repro_torch/serve/graphs.py"
MESH_REL = "src/repro_torch/parallel/mesh.py"
# where each file's findings point
_ANCHORS = {GRAPHS_REL: r"^class Step", ENGINE_REL: r"^class Engine",
            MESH_REL: r"def _reduce"}
ARCH = "qwen1.5-0.5b"
SPEC_K = 2
SMOKE_MAX_NEW = 12                 # tokens a smoke-trace request asks for
TP = 2                             # ranks of the collective audit
COLLECTIVE_MAX_NEW = 3
# a leaf of at least this many elements is a weight the capture rule and
# the all-gather rule watch: every matrix of reduced qwen1.5-0.5b (128 x
# 128 and up) and of the full-width archs, no norm scale or bias
LARGE_LEAF_NUMEL = 1 << 14
# The memory pool of one captured smoke-trace step may reserve this much.
# On the H100 at full width each graph's pool held one 20 MiB segment and
# one 2 MiB segment (the caching allocator's smallest segments for blocks
# over and under 1 MiB; the step's largest block, the prefill chunk's
# 4.9 MB logits, fits in the first).  A copy of a bitplane leaf (16.8 MB
# and up) or of the embedding cannot fit in what is left, so it opens
# another segment and fails; a single 4 MiB f32 matrix may fit, and only
# the element-count rule sees it.
GRAPH_POOL_MARGIN = 24 << 20
POOL_NAMES = ("pool_k", "pool_v", "scale_k", "scale_v")

# Captures each smoke trace must cost, per step: one each (chunked prefill
# runs every chunk at one shape; spec rounds reuse one draft and one
# verify graph; eviction and rollback are host bookkeeping).  Under spec
# decoding every round goes through draft + verify, so the plain decode
# step never runs (0: a fallback dispatch sneaking in would show).
EXPECTED_CAPTURES: Dict[str, Dict[str, int]] = {
    "plain": {"prefill": 1, "decode": 1},
    "spec": {"prefill": 1, "decode": 0, "draft": 1, "verify": 1},
}

# Collectives of one step of reduced qwen1.5-0.5b (2 layers, vocab 512,
# 4 heads) at TP 2, by op: an all-reduce for the vocab-parallel embedding
# lookup, one per row-parallel linear (attention wo and MLP wo, per
# layer), and one all-gather combining the vocab shards of the logits
# for the argmax (``Mesh.gather_columns``).
EXPECTED_COLLECTIVES: Dict[str, Dict[str, int]] = {
    "decode": {"all-reduce": 5, "all-gather": 1},
    "prefill": {"all-reduce": 5, "all-gather": 1},
}


def _at(rel: str) -> int:
    return line_of(rel, _ANCHORS[rel])


def step_counts(eng) -> Dict[str, int]:
    """Captures per step since the engine was built (``Step.captures``
    where it graphs, ``Step.binds`` where it runs eagerly)."""
    return {name: st.captures if st.graphs else st.binds
            for name, st in eng.steps.items()}


def smoke_prompts(vocab: int):
    """Three prompts of 20, 19 and 24 tokens; the first two share a
    16-token prefix (a prefix-cache hit)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, 16).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, vocab, 4)
                            .astype(np.int32)]),
            np.concatenate([shared, rng.integers(1, vocab, 3)
                            .astype(np.int32)]),
            rng.integers(1, vocab, 24).astype(np.int32)]


def run_smoke_trace(params, cfg, *, spec_k: int = 0, device="cpu"):
    """Chunked prefill + decode (+ spec rounds) + eviction on a tiny pool:
    (the engine, its step counts, its stats).  An optimistic reserve and a
    pool the two slots outgrow mid-decode run the page-starved growth
    path, so the trace evicts."""
    from repro_torch.serve import Engine
    eng = Engine(params, cfg, n_slots=2, page_size=8, n_pages=7,
                 max_seq_pages=6, prefill_chunk=8, prefix_cache=True,
                 reserve="optimistic", spec_decode=spec_k, device=device)
    for p in smoke_prompts(cfg.vocab_size):
        eng.submit(p, max_new=SMOKE_MAX_NEW)
    eng.run()
    return eng, step_counts(eng), eng.stats()


def check_capture_counts(counts: dict, stats: Optional[dict], mode: str
                         ) -> List[Finding]:
    """One trace's counts against ``EXPECTED_CAPTURES[mode]``; with the
    trace's ``stats``, it must have evicted (the smoke traces do)."""
    want = EXPECTED_CAPTURES[mode]
    out: List[Finding] = []
    for name, n in want.items():
        got = counts.get(name, 0)
        if got != n:
            out.append(Finding(
                RULE_RECOMPILE, GRAPHS_REL, _at(GRAPHS_REL),
                f"{mode} smoke trace: '{name}' captured {got}x (expected "
                f"exactly {n}): " + (
                    "a step is captured again" if got > n else
                    "the step never ran; the trace no longer exercises "
                    "it")))
    for name in sorted(set(counts) - set(want)):
        out.append(Finding(
            RULE_RECOMPILE, GRAPHS_REL, _at(GRAPHS_REL),
            f"{mode} smoke trace: step '{name}' is not in the pinned "
            "table"))
    if stats is not None and stats.get("evictions", 0) < 1:
        out.append(Finding(
            RULE_RECOMPILE, ENGINE_REL, _at(ENGINE_REL),
            f"{mode} smoke trace ran 0 evictions: it no longer exercises "
            "the page-starved growth path"))
    return out


def reduced_model(device="cpu"):
    """Reduced qwen1.5-0.5b (f32, plain paged attention) from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = dataclasses.replace(get_config(ARCH).reduced(),
                              attention_backend="kernel")
    return init_model(cfg, seed=0, device=device), cfg


# ---------------------------------------------------------------------------
# donation: pools updated in place
# ---------------------------------------------------------------------------

def pool_tensors(layers) -> Dict[str, torch.Tensor]:
    """``layers/<i>/<pool>`` → every pool tensor."""
    return {f"layers/{i}/{name}": t for i, layer in enumerate(layers)
            for name, t in layer.items() if name in POOL_NAMES}


def pool_ptrs(layers) -> Dict[str, int]:
    """``layers/<i>/<pool>`` → data_ptr of every pool tensor."""
    return {k: t.data_ptr() for k, t in pool_tensors(layers).items()}


def check_donation(eng, run: Callable[[], None]) -> List[Finding]:
    """Run ``run()`` (steps of ``eng``) and check that every pool of
    ``eng.kv.layers`` keeps its storage and that each step is bound to
    those very layers.  The pools of before are held through the run, so
    a copy cannot land at a freed pool's address."""
    before = pool_tensors(eng.kv.layers)
    ptrs = {k: t.data_ptr() for k, t in before.items()}
    run()
    now = pool_tensors(eng.kv.layers)
    after = pool_ptrs(eng.kv.layers)
    out: List[Finding] = []
    for path, t in before.items():
        if now.get(path) is not t or after.get(path) != ptrs[path]:
            out.append(Finding(
                RULE_DONATION, ENGINE_REL, _at(ENGINE_REL),
                f"pool '{path}' moved to new storage across steps: the "
                "step copied it instead of updating it in place (the "
                "pools would exist twice on the card)"))
    for name, st in eng.steps.items():
        fn = getattr(st.fn, "func", None) and st.fn
        bound = fn.args[1] if fn is not None and len(fn.args) > 1 else None
        if bound is None:
            continue
        if pool_ptrs(bound) != after:
            out.append(Finding(
                RULE_DONATION, ENGINE_REL, _at(ENGINE_REL),
                f"step '{name}' is bound to pools other than the cache's"))
    if not before:
        out.append(Finding(RULE_DONATION, ENGINE_REL, _at(ENGINE_REL),
                           "the engine's cache holds no pool to check"))
    return out


# ---------------------------------------------------------------------------
# capture purity: no weight-sized tensor made by a step
# ---------------------------------------------------------------------------

class AllocRecorder(TorchDispatchMode):
    """Records (op, shape, storage elements, storage ptr, the storage ptrs
    of the op's tensor inputs) of every tensor an op returns inside the
    ``with`` body; a storage's elements are counted at the output's
    dtype."""

    def __init__(self):
        super().__init__()
        self.records: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = None
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                if ins is None:
                    ins = frozenset(
                        x.untyped_storage().data_ptr()
                        for x in tree_leaves((args, kwargs))
                        if isinstance(x, torch.Tensor)
                        and x.device.type != "meta")
                st = t.untyped_storage()
                self.records.append((str(func), tuple(t.shape),
                                     st.nbytes() // t.element_size(),
                                     st.data_ptr(), ins))
        return out


def weight_sizes(params) -> Tuple[Dict[int, dict], set, int]:
    """(storage ptr → {numel: path} of the leaves of at least
    ``LARGE_LEAF_NUMEL`` elements on it; every leaf's storage ptr; the
    bytes of the smallest such leaf)."""
    from repro_torch.analysis.shardcheck import leaf_paths
    large, ptrs, least = {}, set(), None
    for path, t in leaf_paths(params):
        if not isinstance(t, torch.Tensor):
            continue
        ptr = t.untyped_storage().data_ptr()
        ptrs.add(ptr)
        if t.numel() >= LARGE_LEAF_NUMEL:
            large.setdefault(ptr, {}).setdefault(t.numel(), path)
            nb = t.numel() * t.element_size()
            least = nb if least is None else min(least, nb)
    return large, ptrs, least or 0


def check_capture(records, params, label: str) -> List[Finding]:
    """No recorded op reads a large param leaf and writes new storage of
    as many elements, whatever its dtype: a copy of the weight."""
    large, ptrs, _ = weight_sizes(params)
    out, seen = [], set()
    for op, shape, numel, ptr, ins in records:
        if ptr in ptrs:
            continue
        src = [large[i][numel] for i in ins
               if numel in large.get(i, ())]
        if src and (op, shape) not in seen:
            seen.add((op, shape))
            out.append(Finding(
                RULE_CAPTURE, GRAPHS_REL, _at(GRAPHS_REL),
                f"{label}: {op} read param '{src[0]}' and made a {shape} "
                f"tensor of as many elements ({numel}): a weight copied "
                "into the step (and into a graph's memory pool)"))
    return out


def graph_pools() -> Dict[tuple, int]:
    """Reserved bytes of each private memory pool on the card (the CUDA
    graphs' pools), from the caching allocator's segments."""
    out: Dict[tuple, int] = collections.Counter()
    for seg in torch.cuda.memory_snapshot():
        pid = tuple(seg.get("segment_pool_id", (0, 0)))
        if pid != (0, 0):
            out[pid] += seg["total_size"]
    return dict(out)


def check_graph_pools(pool_bytes: int, n_graphs: int, least_leaf: int,
                      label: str) -> List[Finding]:
    """The memory pools of a trace's graphs hold at most
    ``GRAPH_POOL_MARGIN`` a graph."""
    limit = n_graphs * GRAPH_POOL_MARGIN
    if pool_bytes <= limit:
        return []
    return [Finding(
        RULE_CAPTURE, GRAPHS_REL, _at(GRAPHS_REL),
        f"{label}: its {n_graphs} graphs' memory pools reserve "
        f"{pool_bytes} bytes, over {GRAPH_POOL_MARGIN} a graph ({limit}; "
        f"the smallest large leaf is {least_leaf} bytes): a weight copied "
        "into a graph's memory pool")]


def audit_engine_trace(params, cfg, *, device="cpu"
                       ) -> Tuple[List[Finding], dict]:
    """The smoke traces with their captures recorded: capture counts and
    capture purity; on the card also the memory its graphs' pools
    reserve, held by ``check_graph_pools``, and the memory its engine
    reserves in all (``memory_stats`` with the cache emptied before it:
    graph pools, KV pools, and the eager steps' blocks the allocator
    keeps), logged."""
    out: List[Finding] = []
    report = {}
    cuda = torch.device(device).type == "cuda"
    least = weight_sizes(params)[2]
    for mode, k in (("plain", 0), ("spec", SPEC_K)):
        if cuda:
            gc.collect()                  # earlier engines' graphs and pools
            torch.cuda.empty_cache()
        r0 = torch.cuda.memory_stats(device).get(
            "reserved_bytes.all.current", 0) if cuda else 0
        pools0 = graph_pools() if cuda else {}
        with AllocRecorder() as rec:
            eng, counts, st = run_smoke_trace(params, cfg, spec_k=k,
                                              device=device)
        out += check_capture_counts(counts, st, mode)
        out += check_capture(rec.records, params, f"{mode} smoke trace")
        report[mode] = {"captures": counts,
                        "evictions": st.get("evictions"),
                        "spec_rounds": st.get("spec_rounds"),
                        "ops_recorded": len(rec.records)}
        if cuda:
            growth = torch.cuda.memory_stats(device).get(
                "reserved_bytes.all.current", 0) - r0
            kv = sum(t.numel() * t.element_size()
                     for t in pool_tensors(eng.kv.layers).values())
            n_graphs = sum(counts.values())
            pool = sum(b for pid, b in graph_pools().items()
                       if pid not in pools0)
            out += check_graph_pools(pool, n_graphs, least,
                                     f"{mode} smoke trace")
            report[mode].update(reserved_growth_bytes=growth,
                                kv_pool_bytes=kv, graphs=n_graphs,
                                graph_pool_bytes=pool,
                                least_leaf_bytes=least)
        del eng
    return out, report


# ---------------------------------------------------------------------------
# collectives at TP 2
# ---------------------------------------------------------------------------

def _record_steps(eng, mesh, log):
    """Wrap each step of ``eng`` to append (name, ops, op shapes) of its
    collectives on ``mesh`` to ``log``."""
    for name, st in eng.steps.items():
        fn = st.fn

        def run(*a, _fn=fn, _name=name, **kw):
            ops0 = collections.Counter(mesh.by_op)
            sh0 = collections.Counter(mesh.op_shapes)
            out = _fn(*a, **kw)
            ops = collections.Counter(mesh.by_op)
            ops.subtract(ops0)
            sh = collections.Counter(mesh.op_shapes)
            sh.subtract(sh0)
            log.append((_name, dict(+ops), dict(+sh)))
            return out
        st.fn = run


def protected_sizes(params, pool_shapes) -> Dict[int, str]:
    """numel → what a payload of that many elements would reassemble: a
    whole pool, or a whole param leaf of at least ``LARGE_LEAF_NUMEL``
    elements."""
    from repro_torch.analysis.shardcheck import leaf_paths
    out = {}
    for name, shape in pool_shapes.items():
        out.setdefault(int(np.prod(shape)), f"pool {name} {shape}")
    for path, t in leaf_paths(params):
        if t.numel() >= LARGE_LEAF_NUMEL:
            out.setdefault(t.numel(), f"param {path} {tuple(t.shape)}")
    return out


def check_collectives(log, protected=None, single=None) -> List[Finding]:
    """Each recorded TP step's ops against ``EXPECTED_COLLECTIVES``, no
    all-gather of a protected size, and ``single`` (a single-rank run's
    ops) empty."""
    want_all = EXPECTED_COLLECTIVES
    out: List[Finding] = []
    kinds = set()
    for name, ops, shapes in log:
        want = want_all.get(name)
        if want is None:
            continue
        kinds.add(name)
        if ops != want:
            out.append(Finding(
                RULE_COLLECTIVES, MESH_REL, _at(MESH_REL),
                f"TP 2 '{name}' step made {ops}, the pinned table says "
                f"{want}"))
        for (op, shape), n in shapes.items():
            numel = int(np.prod(shape))
            if op == "all-gather" and numel in (protected or {}):
                out.append(Finding(
                    RULE_COLLECTIVES, MESH_REL, _at(MESH_REL),
                    f"TP 2 '{name}' step all-gathers {shape}: the size of "
                    f"{protected[numel]} (a stray all-gather reassembling "
                    "a sharded pool or weight)"))
    for name in sorted(set(want_all) - kinds):
        out.append(Finding(RULE_COLLECTIVES, MESH_REL, _at(MESH_REL),
                           f"no TP 2 '{name}' step was recorded"))
    if single:
        out.append(Finding(
            RULE_COLLECTIVES, MESH_REL, _at(MESH_REL),
            f"a single-rank step made collectives: {single}"))
    return out


def _collective_rank(mesh):
    """Rank body of ``run_collectives``: serve two prompts at TP 2 on the
    CPU, recording each step's collectives; then the same engine without
    the model axis under a (2, 1) mesh, whose model axis must count none.
    Returns (log, single-rank ops, the protected sizes)."""
    import torch as _torch
    from repro_torch.parallel.mesh import Mesh, set_mesh
    from repro_torch.serve import Engine
    _torch.set_num_threads(1)
    params, cfg = reduced_model("cpu")
    kw = dict(n_slots=2, page_size=8, n_pages=16, prefill_chunk=8,
              device="cpu")
    eng = Engine(params, cfg, mesh=mesh, **kw)
    log: list = []
    _record_steps(eng, mesh, log)
    rng = np.random.default_rng(0)
    for n in (11, 6):
        eng.submit(rng.integers(1, cfg.vocab_size, n).astype(np.int32),
                   max_new=COLLECTIVE_MAX_NEW)
    eng.run()
    whole = {name: tuple(s * mesh.n_model if i == 2 else s
                         for i, s in enumerate(t.shape))
             for name, t in eng.kv.layers[0].items()}
    protected = protected_sizes(params, whole)
    single_mesh = Mesh(n_data=2, n_model=1)      # every rank makes it
    eng1 = Engine(params, cfg, **kw)
    eng1.submit(rng.integers(1, cfg.vocab_size, 9).astype(np.int32),
                max_new=3)
    with set_mesh(single_mesh):
        eng1.run()
    return log, dict(single_mesh.by_op), protected


def run_collectives() -> Tuple[List[Finding], dict]:
    """The TP collective audit over ``TP`` gloo ranks on the CPU."""
    from repro_torch.parallel.mesh import run_ranks
    log, single, protected = run_ranks(_collective_rank, TP, device="cpu")
    f = check_collectives(log, protected, single)
    by_kind = collections.defaultdict(list)
    for name, ops, _ in log:
        by_kind[name].append(ops)
    return f, {"steps": {k: v[0] for k, v in by_kind.items()},
               "n_steps": {k: len(v) for k, v in by_kind.items()},
               "single_rank": single}


def run_compiled() -> Tuple[List[Finding], dict]:
    """The rules that run on the CPU: the smoke traces' capture counts
    and purity on reduced qwen1.5-0.5b, donation across a serve, and the
    TP 2 collective table."""
    params, cfg = reduced_model("cpu")
    findings, report = [], {}
    f, report["traces"] = audit_engine_trace(params, cfg)
    findings += f
    eng, _, _ = run_smoke_trace(params, cfg)

    def more():
        eng.submit(smoke_prompts(cfg.vocab_size)[2], max_new=6)
        eng.run()
    findings += check_donation(eng, more)
    report["donation_pools"] = len(pool_ptrs(eng.kv.layers))
    f, report["collectives"] = run_collectives()
    findings += f
    return findings, report
