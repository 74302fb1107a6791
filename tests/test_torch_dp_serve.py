"""Serving reduced qwen1.5-0.5b over a data axis (gloo, the CPU): a 2x1
and a 2x2 mesh, each spawned once for the module
(``parallel.mesh.run_ranks(..., n_data=2)``), run the continuous engine
with bf16, int8 and int4 pools, the prefix cache, spec decoding at k = 4
and exact-encoded serving from a bundle the reference built, at
``n_slots = 4`` (the decode, draft and verify rows split over the two
data rows) and, for bf16 and spec, at ``n_slots = 3`` (every step
replicated), and the static engine with chunks of 2 requests (split) and
a last chunk of 1 (replicated).

Each serve gives token for token the JAX package's single-device engine
and the port's single rank.  Every rank holds the same tokens, stats,
allocator state, page tables and lens.  ``Mesh.by_axis`` shows one
data-axis all-gather per split decode step, spec round and split static
chunk and none where the batch is replicated, and each step's model-axis
collectives are the pinned ``1 x 2`` table of the collective audit
(``analysis/compiled.py``).  The prefix trace's shared pages are hit from
slots of both data rows.  The rank processes import no JAX.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "qwen1.5-0.5b"
MESHES = ((2, 1), (2, 2))
# (case, n_slots)
CASES = (("bf16", 4), ("int8", 4), ("int4", 4), ("prefix", 4),
         ("spec", 4), ("encoded", 4), ("bf16", 3), ("spec", 3),
         ("static", 2))
KW = dict(page_size=8, n_pages=64, prefill_chunk=16)
MAX_NEW = 8


def _key(case):
    return f"{case[0]}/{case[1]}"


def _trace():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (40, 13, 35, 7, 50)]


def _prefix_trace():
    """Prompts 0, 4 and 5 share a 24-token prefix (3 pages).  Prompt 0
    is prefilled while 1-3 fill the other slots; 1 and 3 finish first, so
    4 and 5 are admitted into slots 1 and 3, one on each data row of
    ``n_slots = 4``, and both hit the pages prompt 0 wrote."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 512, 24).astype(np.int32)

    def own(n):
        return rng.integers(0, 512, n).astype(np.int32)
    return [np.concatenate([shared, own(5)]), own(7), own(40), own(12),
            np.concatenate([shared, own(9)]),
            np.concatenate([shared, own(3)])]


def _kv(case):
    return case[0] if case[0] in ("int8", "int4") else "bf16"


def _tcfg(case):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH).reduced(),
                               kv_cache_dtype=_kv(case),
                               attention_backend="kernel")


def _serve(params, case, mesh=None, bundle=None, log=None):
    """One serve: (tokens, engine).  ``log``: per step call, (name, its
    model-axis collectives); and the slots whose admission hit the
    prefix cache, under ``log["hits"]``."""
    from repro_torch.serve import (Engine, ServeEngine, exact_encodings,
                                   prepare_encoded_serving)
    name, slots = case
    cfg = _tcfg(case)
    if name == "encoded":
        params, cfg, _ = prepare_encoded_serving(
            params, cfg, macs_override=exact_encodings(), cache_dir=bundle,
            device="cpu", verbose=False)
    if name == "static":
        eng = ServeEngine(params, cfg, batch_slots=slots, device="cpu",
                          mesh=mesh)
        return [o.tolist() for o in eng.run(_trace(), max_new=MAX_NEW)], eng
    kw = {"prefix": dict(prefix_cache=True),
          "spec": dict(spec_decode=4)}.get(name, {})
    eng = Engine(params, cfg, device="cpu", mesh=mesh, n_slots=slots, **KW,
                 **kw)
    if log is not None:
        _record(eng, mesh, log)
    trace = _prefix_trace() if name == "prefix" else _trace()
    rids = [eng.submit(p, max_new=MAX_NEW) for p in trace]
    outs = eng.run()
    return [outs[r].tolist() for r in rids], eng


def _record(eng, mesh, log):
    """Wrap each step to log its model-axis collectives, and admissions
    to log the slots that hit the prefix cache."""
    log.setdefault("steps", [])
    log.setdefault("hits", [])
    for name, st in eng.steps.items():
        def run(*a, _fn=st.fn, _name=name):
            before = collections.Counter(mesh.by_axis)
            out = _fn(*a)
            ops = collections.Counter(mesh.by_axis)
            ops.subtract(before)
            log["steps"].append((_name, {op: n for (ax, op), n in ops.items()
                                         if ax == "model" and n}))
            return out
        st.fn = run
    admit = eng.sched.admissions

    def admissions():
        got = admit()
        log["hits"] += [slot for slot, req in got if req.n_cached > 0]
        return got
    eng.sched.admissions = admissions


_CLOCKS = ("_ms", "_s_", "latency", "ttft", "tpot")


def _rank(mesh, params, bundle):
    """Every case on this rank: tokens, the ranks' agreement, the mesh
    stats, the data axis's gathers, each step's model collectives."""
    out = {}
    for case in CASES:
        log = {}
        gathers = mesh.by_axis[("data", "all-gather")]
        toks, eng = _serve(params, case, mesh, bundle, log)
        st = eng.stats()
        det = {k: v for k, v in st.items()
               if not any(c in k for c in _CLOCKS) and not k.endswith("_s")}
        state = (det,) if case[0] == "static" else (
            det, eng.kv.alloc.state(), eng.kv.ptab.tolist(),
            eng.kv.lens.tolist())
        out[_key(case)] = {
            "tokens": toks, "agree": mesh.agree((toks, state)),
            "mesh": st["mesh"], "split": st["data_split"],
            "replicated": st["mesh_replicated"],
            "gathers": mesh.by_axis[("data", "all-gather")] - gathers,
            "decode_steps": st.get("decode_steps"),
            "spec_rounds": st.get("spec_rounds"),
            "chunks": getattr(eng, "chunks", None),
            "steps": log.get("steps"), "hits": log.get("hits")}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's single-device tokens, the port's single rank's,
    and rank 0's results on each mesh."""
    import concurrent.futures
    import jax
    from repro.configs import get_config as jget
    from repro.core.circuits import exact_product_circuit
    from repro.core.encoding import EncodingSpec
    from repro.core.mac import EncodedMac
    from repro.models import init_model as j_init
    from repro.serve import Engine as JEngine
    from repro.serve.encoded import prepare_encoded_serving as j_prepare
    from repro.serve.engine import ServeEngine as JServe
    from repro_torch.models import params_from_jax
    from repro_torch.parallel.mesh import run_ranks
    jcfg = jget(ARCH).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    bundle = str(tmp_path_factory.mktemp("ref_bundle"))
    jpe, jce, _ = j_prepare(jp, jcfg, macs_override={
        n: mac for n in ("wq", "wk", "wv", "wo", "wi", "wg", "w")},
        cache_dir=bundle, verbose=False)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             _tcfg(CASES[0]), "cpu")
    # the meshes' ranks run while this process runs the reference
    pool = concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(lambda: {shape: run_ranks(
        _rank, shape[1], params, bundle, n_data=shape[0], timeout=600)
        for shape in MESHES})
    want = {}
    for case in CASES:
        name, slots = case
        if name == "static":
            want[_key(case)] = [np.asarray(o).tolist() for o in JServe(
                jp, jcfg, batch_slots=slots).run(_trace(), max_new=MAX_NEW)]
            continue
        p, c = (jpe, jce) if name == "encoded" else (jp, jcfg)
        c = dataclasses.replace(c, kv_cache_dtype=_kv(case),
                                attention_backend="pallas")
        kw = {"prefix": dict(prefix_cache=True),
              "spec": dict(spec_decode=4)}.get(name, {})
        eng = JEngine(p, c, n_slots=slots, **KW, **kw)
        trace = _prefix_trace() if name == "prefix" else _trace()
        rids = [eng.submit(q, max_new=MAX_NEW) for q in trace]
        res = eng.run()
        want[_key(case)] = [np.asarray(res[r]).tolist() for r in rids]
    single = {_key(c): _serve(params, c, bundle=bundle)[0] for c in CASES}
    ranks = fut.result()
    pool.shutdown()
    return want, single, ranks


KEYS = [_key(c) for c in CASES]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("key", KEYS)
def test_tokens_match_reference_and_single_rank(runs, key, shape):
    want, single, ranks = runs
    assert single[key] == want[key]
    assert ranks[shape][key]["tokens"] == want[key]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("key", KEYS)
def test_ranks_agree_and_gather_once_a_split_step(runs, key, shape):
    """Every rank holds the same tokens and host state; a split step
    (continuous at 4 slots, a static chunk of 2) is gathered once over
    the data axis, a replicated one not at all."""
    r = runs[2][shape][key]
    name, slots = key.split("/")
    assert r["agree"]
    assert r["mesh"] == {"data": shape[0], "model": shape[1]}
    assert r["replicated"] == []
    if name == "static":
        split = [c["rows"] < c["batch"] for c in r["chunks"]]
        assert split == [True, True, False]
        assert r["gathers"] == sum(split) and r["split"]
        assert [c["rows"] for c in r["chunks"]] == [1, 1, 1]
        return
    assert r["split"] == (slots == "4")
    rounds = r["spec_rounds"] if name == "spec" else r["decode_steps"]
    assert rounds > 0
    assert r["gathers"] == (rounds if r["split"] else 0)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("key", [k for k in KEYS
                                 if not k.startswith("static")])
def test_model_axis_collectives_are_the_tp_table(runs, key, shape):
    """Each step's model-axis collectives are those of the ``1 x M``
    table the collective audit pins (none at M = 1); a draft call runs k
    decode forwards."""
    from repro_torch.analysis.compiled import EXPECTED_COLLECTIVES
    steps = runs[2][shape][key]["steps"]
    assert {name for name, _ in steps} >= {"prefill"}
    for name, ops in steps:
        if shape[1] == 1:
            assert ops == {}
            continue
        base = EXPECTED_COLLECTIVES["prefill" if name == "prefill"
                                    else "decode"]
        times = 4 if name == "draft" else 1
        assert ops == {op: n * times for op, n in base.items()}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "%dx%d" % s)
def test_prefix_hits_come_from_both_data_rows(runs, shape):
    hits = runs[2][shape]["prefix/4"]["hits"]
    rows = {slot // 2 for slot in hits}
    assert rows == {0, 1}
