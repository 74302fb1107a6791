"""Seeded-mutation self-test: each checker catches the defect it exists
for (port of ``repro/analysis/selftest.py``).

A static analyzer that silently stops finding anything is worse than
none.  Each case plants one representative defect and asserts that its
checker reports it; a defect that goes unreported is an **escape**, and
``python -m repro_torch.analysis --self-test`` fails on any.

Defects are injected, never written into the tree: the kernel cases pass
mutated plan functions, constants and ``ARGTYPES`` into the check cores,
the sharding cases a planted leaf and a flipped roles table, the lint
cases run on a synthetic repo in a temp directory, the ledger cases drive
a tiny sanitized ``PagedKVCache`` through illegal transitions, and the
captured-step cases copy a pool of a scratch engine and add a stray
all-gather to a recorded collective log.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import tempfile
import textwrap
from typing import Callable, List, Tuple

Case = Tuple[str, Callable[[], bool]]      # (name, returns True if caught)

# a few registry-like geometries: enough for each planted defect to show
_K1_SHAPES = [(1024, 1024), (1024, 2816), (2816, 1024), (130, 70)]
_K1_U = (1, 8, 15, 48, 92)


def _kernel_chunk_off_by_one() -> bool:
    from repro_torch.analysis.kernelcheck import check_kernel1
    from repro_torch.kernels import encoded_matmul as em

    def bad_runs(p):
        runs = em.chunk_runs(p)
        b, e = runs[-1]
        return runs[:-1] + [(b, e + 1)]           # one chunk past the end

    f, _ = check_kernel1(_K1_SHAPES, runs_fn=bad_runs, U_values=_K1_U,
                         m_values=(4,), sms=(132,), label="selftest")
    return any("chunk runs" in x.message for x in f)


def _kernel_page_past_used() -> bool:
    from repro_torch.analysis.kernelcheck import check_kernel2
    from repro_torch.kernels import paged_attention as pa

    def bad_rank(nb, cl, z, bp):
        b, e = pa.rank_pages(nb, cl, z, bp)
        return b, (e + 1 if e == nb and e > b else e)   # reads page nb

    f, _ = check_kernel2((16,), rank_fn=bad_rank, batches=(4,), max_p=40,
                         sms=(132,), label="selftest")
    return any("past pages_used" in x.message for x in f)


def _kernel_cluster_from_lens() -> bool:
    from repro_torch.analysis.kernelcheck import check_kernel2
    from repro_torch.kernels import paged_attention as pa

    def bad_cluster(B, Hkv, P, sms, lens):
        return max(1, min(pa.MAX_CLUSTER, max(lens) // 128 + 1))

    f, _ = check_kernel2((16,), cluster_fn=bad_cluster, batches=(4,),
                         max_p=40, sms=(132,), label="selftest")
    return any("over the lens" in x.message for x in f)


def _kernel_constant_changed() -> bool:
    from repro_torch.analysis.kernelcheck import EM_REL, check_constants
    from repro_torch.kernels import encoded_matmul as em
    f, _ = check_constants(values={(EM_REL, "KC"): em.KC + 1})
    return any("KC" in x.message for x in f)


def _kernel_argtype_int_for_pointer() -> bool:
    from repro_torch.analysis.kernelcheck import EM_REL, check_abi
    from repro_torch.kernels import encoded_matmul as em
    bad = (ctypes.c_int,) + tuple(em.ARGTYPES[1:])       # x as c_int
    f, _ = check_abi(argtypes={(EM_REL, "ARGTYPES"): bad})
    return any("ARGTYPES[0] is int" in x.message for x in f)


def _shard_unruled_leaf() -> bool:
    import torch
    from repro_torch.analysis.shardcheck import (_arch_params,
                                                 check_param_coverage)
    params = dict(_arch_params("qwen1.5-0.5b"))
    layer = dict(params["layers"][0])
    layer["attn"] = dict(layer["attn"], wextra=torch.empty(
        (1024, 2048), device="meta"))             # no role, 2M elements
    params["layers"] = [layer] + params["layers"][1:]
    f = check_param_coverage("qwen1.5-0.5b", params=params)
    return any("wextra" in x.message for x in f)


def _shard_fold_role_flip() -> bool:
    from repro_torch.analysis.shardcheck import check_fold_roles
    from repro_torch.parallel.sharding import LINEAR_ROLES
    roles = dict(LINEAR_ROLES, wq="row")          # a column linear as row
    f = check_fold_roles("qwen1.5-0.5b", roles=roles)
    return any("wq_fw" in x.message and "row-parallel" in x.message
               for x in f)


def _tiny_kv():
    from repro_torch.configs import get_config
    from repro_torch.serve.paged_cache import PagedKVCache
    cfg = get_config("qwen1.5-0.5b").reduced()
    return PagedKVCache(cfg, n_slots=2, n_pages=8, page_size=8,
                        max_seq_pages=4, device="cpu", sanitize=True)


def _ledger_double_free() -> bool:
    from repro_torch.analysis.ledger import LedgerError
    kv = _tiny_kv()
    pages = kv.alloc.alloc(2)
    kv.alloc.free(pages)
    try:
        kv.alloc.free(pages)                      # double free
    except LedgerError:
        return True
    return False


def _ledger_use_after_free() -> bool:
    from repro_torch.analysis.ledger import LedgerError
    kv = _tiny_kv()
    pages = kv.alloc.alloc(1)
    kv.alloc.free(pages)
    try:
        kv.set_pages(0, pages)                    # stale page table
    except LedgerError:
        return True
    return False


def _ledger_foreign_copy() -> bool:
    from repro_torch.analysis.ledger import LedgerError
    kv = _tiny_kv()
    pages = kv.alloc.alloc(1)
    try:
        kv.copy_page(pages[0], pages[0] + 1)      # COW into an unowned page
    except LedgerError:
        return True
    return False


_SYNTH_ENGINE = textwrap.dedent("""\
    import torch

    class Engine:
        def run(self):
            while True:
                self.step()

        def step(self):
            toks = self._dispatch()
            {annot}
            out = toks.item()
            return out

        def _dispatch(self):
            return torch.zeros(1)
    """)


def _synth_repo(files: dict):
    """A temp repo with ``files`` ({repo-relative path: text}); returns
    (its parsed Repo, the directory to remove)."""
    from repro_torch.analysis.lint import Repo
    tmp = tempfile.mkdtemp(prefix="analysis-selftest-")
    for rel, text in files.items():
        path = os.path.join(tmp, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    return Repo(tmp), tmp


def _lint_engine(annot: str):
    from repro_torch.analysis.lint import run_lint
    pkg = "src/repro_torch"
    repo, tmp = _synth_repo({
        f"{pkg}/__init__.py": "", f"{pkg}/serve/__init__.py": "",
        f"{pkg}/serve/engine.py": _SYNTH_ENGINE.format(annot=annot)})
    try:
        return run_lint(repo=repo)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _lint_hot_sync_caught() -> bool:
    f = _lint_engine("pass")
    return any(x.rule == "host-sync-in-hot-path" for x in f)


_SYNTH_NESTED = textwrap.dedent("""\
    from typing import Optional

    import torch

    class Monitor:
        def sample(self, x):
            return x.cpu()

    class Telemetry:
        def __init__(self, monitor: Optional[Monitor] = None):
            self.monitor = monitor

        @classmethod
        def disabled(cls) -> "Telemetry":
            return cls()

    class Engine:
        def __init__(self, telemetry: Optional[Telemetry] = None):
            self.tel = telemetry if telemetry is not None else \\
                Telemetry.disabled()

        def run(self):
            self.step()

        def step(self):
            self.tel.monitor.sample(torch.zeros(1))
    """)


def _lint_nested_attribute_sync() -> bool:
    """A sync two attributes deep (``self.tel.monitor.sample``), the
    types read from annotations and a classmethod's return."""
    from repro_torch.analysis.lint import run_lint
    pkg = "src/repro_torch"
    repo, tmp = _synth_repo({
        f"{pkg}/__init__.py": "", f"{pkg}/serve/__init__.py": "",
        f"{pkg}/serve/engine.py": _SYNTH_NESTED})
    try:
        f = run_lint(repo=repo)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return any(x.rule == "host-sync-in-hot-path" and
               "Monitor.sample" in x.message for x in f)


def _lint_annotation_honored() -> bool:
    f = _lint_engine(
        "# analysis: allow(host-sync): step boundary, tokens must land")
    return not any(x.rule == "host-sync-in-hot-path" for x in f)


def _lint_blanket_rejected() -> bool:
    f = _lint_engine("# analysis: allow(host-sync)")
    return (any(x.rule == "host-sync-in-hot-path" for x in f)
            and any(x.rule == "blanket-suppression" for x in f))


def _metric_docs_drift() -> bool:
    from repro_torch.analysis.rules.metricdocs import check
    repo, tmp = _synth_repo({
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/obs.py":
            "def bind(r):\n    r.counter('fresh_metric', 'help')\n",
        "docs/observability.md":
            "| metric | kind |\n|---|---|\n| `stale_metric` | counter |\n"})
    try:
        f = check(repo)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return (any("fresh_metric" in x.message for x in f)
            and any("stale_metric" in x.message for x in f))


def _f16_accumulation() -> bool:
    from repro_torch.analysis.rules.f32accum import check_csrc
    line = ('asm volatile("mma.sync.aligned.m16n8k16.row.col.f16.f16.f16.'
            'f16 {%0,%1}, ..." : ...);')
    f = check_csrc("src/repro_torch/csrc/planted.cu", [line])
    return any("accumulates in f16" in x.message for x in f)


def _capture_in_loop() -> bool:
    from repro_torch.analysis.rules.jitinloop import check
    repo, tmp = _synth_repo({
        "src/repro_torch/__init__.py": "",
        "src/repro_torch/bench.py": textwrap.dedent("""\
            import torch

            def time_steps(fns):
                for fn in fns:
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g):
                        fn()
            """)})
    try:
        f = check(repo)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return sum("CUDA-graph capture" in x.message for x in f) == 2


def _pool_copied() -> bool:
    import numpy as np
    from repro_torch.analysis.compiled import (RULE_DONATION,
                                               check_donation,
                                               reduced_model)
    from repro_torch.serve import Engine
    params, cfg = reduced_model("cpu")
    eng = Engine(params, cfg, n_slots=2, page_size=8, n_pages=16,
                 prefill_chunk=8, device="cpu")
    step = eng.steps["decode"]
    fn = step.fn

    def copying(*a):                              # a functional update
        out = fn(*a)
        layer = eng.kv.layers[0]
        layer["pool_k"] = layer["pool_k"].clone()
        return out
    step.fn = copying

    def run():
        eng.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
        eng.run()
    f = check_donation(eng, run)
    return any(x.rule == RULE_DONATION for x in f)


def _weight_cast_in_step() -> bool:
    """A step that casts a bf16 weight of the engine's params to f32
    (``w.float()``: twice its bytes, as many elements) is caught."""
    import numpy as np
    import torch
    from repro_torch.analysis.compiled import (RULE_CAPTURE, AllocRecorder,
                                               check_capture, reduced_model)
    from repro_torch.serve import Engine
    params, cfg = reduced_model("cpu")
    emb = params["embed"]                       # the one leaf of its numel
    emb["table"] = w = emb["table"].to(torch.bfloat16)
    eng = Engine(params, cfg, n_slots=2, page_size=8, n_pages=16,
                 prefill_chunk=8, device="cpu")
    step = eng.steps["decode"]
    fn = step.fn

    def casting(*a):
        w.float()
        return fn(*a)
    step.fn = casting
    with AllocRecorder() as rec:
        eng.submit(np.arange(1, 6, dtype=np.int32), max_new=3)
        eng.run()
    f = check_capture(rec.records, params, "planted")
    return any(x.rule == RULE_CAPTURE and "embed/table" in x.message
               for x in f)


def _stray_all_gather() -> bool:
    from repro_torch.analysis.compiled import (EXPECTED_COLLECTIVES,
                                               check_collectives)
    pool = (16, 8, 4, 16)                         # a whole pool
    log = [(name, dict(ops), {("all-reduce", (1, 1, 64)): 5,
                              ("all-gather", (1, 1, 512)): 1})
           for name, ops in EXPECTED_COLLECTIVES.items()]
    name, ops, shapes = log[0]
    log[0] = (name, {**ops, "all-gather": 2},
              {**shapes, ("all-gather", pool): 1})
    f = check_collectives(log, protected={16 * 8 * 4 * 16: "pool pool_k"})
    return any("stray all-gather" in x.message for x in f)


CASES: List[Case] = [
    ("kernel/chunk-run-off-by-one", _kernel_chunk_off_by_one),
    ("kernel/page-past-pages-used", _kernel_page_past_used),
    ("kernel/cluster-from-lens", _kernel_cluster_from_lens),
    ("kernel/mirrored-constant-changed", _kernel_constant_changed),
    ("kernel/argtypes-int-for-pointer", _kernel_argtype_int_for_pointer),
    ("shard/unruled-large-leaf", _shard_unruled_leaf),
    ("shard/fold-role-flip", _shard_fold_role_flip),
    ("ledger/double-free", _ledger_double_free),
    ("ledger/use-after-free", _ledger_use_after_free),
    ("ledger/copy-to-unowned-page", _ledger_foreign_copy),
    ("lint/hot-path-sync-detected", _lint_hot_sync_caught),
    ("lint/nested-attribute-sync-detected", _lint_nested_attribute_sync),
    ("lint/annotation-honored", _lint_annotation_honored),
    ("lint/blanket-suppression-rejected", _lint_blanket_rejected),
    ("lint/metric-docs-drift", _metric_docs_drift),
    ("lint/mma-f16-accumulation", _f16_accumulation),
    ("lint/capture-in-loop", _capture_in_loop),
    ("compiled/pool-copied-not-updated", _pool_copied),
    ("compiled/weight-cast-in-step", _weight_cast_in_step),
    ("compiled/stray-all-gather", _stray_all_gather),
]


def run_selftest() -> List[dict]:
    """Run every seeded mutation; return one report per case.  A case
    with ``caught == False`` is an escape (a checker regression)."""
    out = []
    for name, fn in CASES:
        try:
            caught = bool(fn())
            err = None
        except Exception as e:          # a checker that crashed caught nothing
            caught, err = False, f"{type(e).__name__}: {e}"
        out.append({"case": name, "caught": caught,
                    **({"error": err} if err else {})})
    return out
