"""Port parity for speculative decoding (``serve/spec.py``,
``Engine(spec_decode=k)``, ``prepare_drafter``, the drafter guards and the
CLI flags): the acceptance rules against the reference's under the same
numpy generator, kernel 2's plain version at the verify shapes (Sq = k+1)
against the reference's blocked lowering, and serving with k in {1, 4, 8},
a ``self`` and an ``encoded`` drafter, with and without the prefix cache,
against plain decode and the reference ``Engine`` (reduced qwen1.5-0.5b on
the CPU).  Tokens must be identical; so must the acceptance counts, since
both engines read the same drafter (the port loads the reference's
drafter bundle, a cache hit)."""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.kernels import paged_attention as jpa  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import encoded as JE  # noqa: E402
from repro.serve import spec as jspec  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.macexec import check_drafter, count_prepared  # noqa
from repro_torch.kernels import counts  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402,F401
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import encoded as TE  # noqa: E402
from repro_torch.serve import graphs  # noqa: E402
from repro_torch.serve import spec as tspec  # noqa: E402

# the drafter's search at a test's size
DRAFT_OPTS = dict(m_bits=24, n_samples=16, refine=8, calib_batches=2,
                  calib_batch_size=2, calib_seq=32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jcfg = jget("qwen1.5-0.5b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tget("qwen1.5-0.5b").reduced()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    cache = str(tmp_path_factory.mktemp("drafter"))
    jdp, jdc, _ = JE.prepare_drafter(jp, jcfg, cache_dir=cache,
                                     verbose=False, **DRAFT_OPTS)
    tdp, tdc, info = TE.prepare_drafter(tp, tcfg, cache_dir=cache,
                                        verbose=False, device="cpu",
                                        **DRAFT_OPTS)
    assert info["loaded"] and not info["shared_with_verifier"]
    return {"ref": (jp, jcfg), "port": (tp, tcfg),
            "drafters": {"self": ((None, None), (None, None)),
                         "encoded": ((jdp, jdc), (tdp, tdc))}}


# ---------------------------------------------------------------------------
# acceptance rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft,target", [
    ([], []), ([3], [3]), ([3], [4]), ([1, 2, 3, 4], [1, 2, 9, 4]),
    ([5, 5, 5], [5, 5, 5, 7]), (np.arange(8), np.arange(9))])
def test_greedy_accept_is_the_references(draft, target):
    assert tspec.greedy_accept(draft, target) == \
        jspec.greedy_accept(draft, target)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("sharp", [0.5, 4.0])
def test_rejection_sample_is_the_references(seed, k, sharp):
    """The same inputs and generator seed give the same tokens, the same
    accept count, and leave both generators in the same state."""
    rng = np.random.default_rng(100 + seed)
    V = 11

    def dist(n):
        p = np.exp(sharp * rng.normal(size=(n, V)))
        return p / p.sum(-1, keepdims=True)

    dp, tp = dist(k), dist(k + 1)
    toks = [int(rng.choice(V, p=dp[i])) for i in range(k)]
    dp[0, (toks[0] + 1) % V] = 0.0       # a zero-probability draft token
    g1, g2 = np.random.default_rng(seed), np.random.default_rng(seed)
    assert tspec.rejection_sample(dp, tp, toks, g1) == \
        jspec.rejection_sample(dp, tp, toks, g2)
    assert g1.random() == g2.random()


# ---------------------------------------------------------------------------
# kernel 2's plain version at the verify shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("Sq", [5, 9, 16])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)])
def test_paged_attn_plain_at_verify_shapes(Sq, Hq, Hkv):
    """Sq = k+1 query tokens per row, with rows whose query positions run
    past their page table (the scratch rows of a verify round)."""
    rng = np.random.default_rng(Sq + Hq)
    B, D, ps, P = 4, 16, 4, 6
    n_pages = 1 + B * P
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    pk, pv = (rng.normal(size=(n_pages, ps, Hkv, D)).astype(np.float32)
              for _ in range(2))
    pages = np.stack([1 + b * P + rng.permutation(P)
                      for b in range(B)]).astype(np.int32)
    lens = np.asarray([0, 7, P * ps - Sq, P * ps], np.int32)
    G = Hq // Hkv
    kw = dict(scale=D ** -0.5)
    want = np.asarray(jpa._paged_attn_blocked(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pages),
        jnp.asarray(lens), jpa._NO_WINDOW, G=G, **kw))
    kv_map = np.minimum(np.arange(Hq) // G, Hkv - 1)
    t = torch.from_numpy
    got = tpa.paged_attn(t(q), t(pk), t(pv), t(pages), t(lens),
                         kv_of_q=kv_map, **kw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    assert tpa.MAX_SQ >= 9


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

def _prompts(vocab, lens, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _serve(engine_cls, params, cfg, prompts, *, max_new=10, eos=None,
           **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("n_pages", 64)
    eng = engine_cls(params, cfg, **kw)
    rids = [eng.submit(p, max_new=max_new, eos_id=eos) for p in prompts]
    res = eng.run()
    return [res[r].tolist() for r in rids], eng


def _pair(models, drafter, backend):
    (jp, jcfg), (tp, tcfg) = models["ref"], models["port"]
    jcfg = dataclasses.replace(
        jcfg, attention_backend="xla" if backend == "gather" else "pallas")
    tcfg = dataclasses.replace(tcfg, attention_backend=backend)
    (jdp, jdc), (tdp, tdc) = models["drafters"][drafter]
    return ((jp, jcfg, dict(draft_params=jdp, draft_cfg=jdc)),
            (tp, tcfg, dict(draft_params=tdp, draft_cfg=tdc, device="cpu")))


SPEC_KEYS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
             "spec_acceptance_rate", "spec_tokens_per_round",
             "decode_tokens", "prefill_chunks", "draft_mac_mode")


@pytest.mark.parametrize("drafter", ["self", "encoded"])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_spec_tokens_are_plain_decode_and_the_references(models, drafter, k):
    (jp, jcfg, jkw), (tp, tcfg, tkw) = _pair(models, drafter, "kernel")
    prompts = _prompts(tcfg.vocab_size, (5, 12, 9, 3))
    plain, _ = _serve(TEngine, tp, tcfg, prompts, device="cpu")
    out, eng = _serve(TEngine, tp, tcfg, prompts, spec_decode=k, **tkw)
    jout, jeng = _serve(JEngine, jp, jcfg, prompts, spec_decode=k, **jkw)
    assert out == plain == jout
    st, jst = eng.stats(), jeng.stats()
    assert {x: st[x] for x in SPEC_KEYS} == {x: jst[x] for x in SPEC_KEYS}
    assert st["spec_decode_k"] == k and st["spec_rounds"] > 0
    if drafter == "self":
        assert st["spec_acceptance_rate"] == 1.0
        assert st["spec_rounds"] < st["decode_tokens"]
    else:
        assert st["draft_mac_mode"] == "encoded_infer"


@pytest.mark.parametrize("drafter", ["self", "encoded"])
def test_spec_with_prefix_cache_and_chunked_prefill(models, drafter):
    (jp, jcfg, jkw), (tp, tcfg, tkw) = _pair(models, drafter, "gather")
    rng = np.random.default_rng(5)
    shared = rng.integers(0, tcfg.vocab_size, 11).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, tcfg.vocab_size, n).astype(np.int32)]) for n in (3, 7, 2, 6)]
    kw = dict(prefill_chunk=8, prefix_cache=True)
    plain, _ = _serve(TEngine, tp, tcfg, prompts, device="cpu", **kw)
    out, eng = _serve(TEngine, tp, tcfg, prompts, spec_decode=4, **kw,
                      **tkw)
    jout, jeng = _serve(JEngine, jp, jcfg, prompts, spec_decode=4, **kw,
                        **jkw)
    assert out == plain == jout
    st, jst = eng.stats(), jeng.stats()
    keys = SPEC_KEYS + ("prefix_hit_tokens", "prefix_lookup_tokens",
                        "cow_copies")
    assert {x: st[x] for x in keys} == {x: jst[x] for x in keys}
    assert st["prefix_hit_tokens"] > 0


def test_spec_max_new_and_eos_boundaries(models):
    tp, tcfg = models["port"]
    prompts = _prompts(tcfg.vocab_size, (5, 9))
    for mn in (1, 2, 4, 5):
        a, _ = _serve(TEngine, tp, tcfg, prompts, max_new=mn, device="cpu")
        b, _ = _serve(TEngine, tp, tcfg, prompts, max_new=mn, device="cpu",
                      spec_decode=4)
        assert a == b, mn
    full, _ = _serve(TEngine, tp, tcfg, prompts, device="cpu")
    eos = full[0][4]                     # fires mid-draft
    a, _ = _serve(TEngine, tp, tcfg, prompts, eos=eos, device="cpu")
    b, _ = _serve(TEngine, tp, tcfg, prompts, eos=eos, device="cpu",
                  spec_decode=4)
    assert a == b and a[0][-1] == eos and len(a[0]) == 5


def test_spec_eviction_rollback_matches_reference(models):
    """Two slots over six 4-token pages with optimistic reserve: rounds
    are preempted mid-draft.  Rollback leaks no page, regenerates no token
    and follows the reference step for step."""
    (jp, jcfg), (tp, tcfg) = models["ref"], models["port"]
    prompts = _prompts(tcfg.vocab_size, (5, 3, 6), seed=0)
    kw = dict(n_slots=2, page_size=4, n_pages=6, reserve="optimistic",
              prefill_chunk=4)
    plain, eng0 = _serve(TEngine, tp, tcfg, prompts, device="cpu", **kw)
    out, eng = _serve(TEngine, tp, tcfg, prompts, device="cpu",
                      spec_decode=4, **kw)
    jout, jeng = _serve(JEngine, jp, jcfg, prompts, spec_decode=4, **kw)
    assert out == plain == jout
    st, jst = eng.stats(), jeng.stats()
    keys = SPEC_KEYS + ("evictions", "stalls", "cow_copies", "finished")
    assert {x: st[x] for x in keys} == {x: jst[x] for x in keys}
    assert st["evictions"] >= 1 and st["finished"] == 3
    al, al0 = eng.kv.alloc, eng0.kv.alloc
    assert al.n_held == 0
    assert al.n_free_strict + al.n_cached == al0.n_free_strict + al0.n_cached


def test_drafter_guards(models):
    tp, tcfg = models["port"]
    (tdp, tdc) = models["drafters"]["encoded"][1]
    assert count_prepared(tp, "encoded_infer") == 0
    assert count_prepared(tp, "fp") == -1
    assert count_prepared(tdp, "encoded_infer") == 7 * tcfg.n_layers
    with pytest.raises(ValueError, match="drafter"):
        check_drafter(tp, "encoded_infer")
    kw = dict(n_slots=2, page_size=4, n_pages=16, device="cpu")
    with pytest.raises(ValueError, match="drafter"):
        TEngine(tp, tcfg, spec_decode=2, draft_params=tp, draft_cfg=tdc,
                **kw)
    with pytest.raises(ValueError, match="spec_decode"):
        TEngine(tp, tcfg, spec_decode=-1, **kw)
    bad = dataclasses.replace(tcfg, n_layers=tcfg.n_layers + 1)
    with pytest.raises(ValueError, match="geometry"):
        TEngine(tp, tcfg, spec_decode=2, draft_params=tp, draft_cfg=bad,
                **kw)
    bad = dataclasses.replace(tcfg, kv_cache_dtype="int8")
    with pytest.raises(ValueError, match="geometry"):
        TEngine(tp, tcfg, spec_decode=2, draft_params=tp, draft_cfg=bad,
                **kw)
    # a verifier searched at the drafter's m_bits is its own drafter
    p, c, info = TE.prepare_drafter(tp, tcfg, m_bits=24,
                                    verifier=(tdp, tdc))
    assert p is tdp and c is tdc and info["shared_with_verifier"]


# ---------------------------------------------------------------------------
# the step helper and the engine's graph switch (eager on the CPU)
# ---------------------------------------------------------------------------

def test_graphs_need_the_card(models):
    tp, tcfg = models["port"]
    with pytest.raises(ValueError, match="cuda_graphs"):
        TEngine(tp, tcfg, n_slots=2, page_size=4, n_pages=16, device="cpu",
                cuda_graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs"):
        graphs.Step("x", lambda: None, "cpu", graphs=True)


def test_step_binds_inputs_into_one_buffer():
    seen = []

    def fn(a, b, c):
        seen.append((a.data_ptr(), b.data_ptr(), c))
        return a.sum() + b.sum() + c.sum()

    step = graphs.Step("t", fn, "cpu", graphs=False)
    dev = torch.arange(3, dtype=torch.int32)
    a = np.arange(4, dtype=np.int32).reshape(2, 2)
    b = np.full((3,), 7, np.int32)
    assert int(step(a, b, dev)) == 6 + 21 + 3
    assert int(step(a + 1, b, dev + 1)) == 10 + 21 + 6
    (pa, pb, _), (qa, qb, c2) = seen
    assert (pa, pb) == (qa, qb) and pb - pa == 4 * 4   # one block
    assert step.arg(0).tolist() == (a + 1).tolist()
    with pytest.raises(ValueError, match="shape"):
        step(np.zeros((3, 2), np.int32), b, dev)


def test_launch_count_bookkeeping():
    """What a graph records at capture and adds per replay, over every
    counter the kernel wrappers registered."""
    before = counts.launch_counts()
    try:
        after = dict(before, encoded_matmul=before["encoded_matmul"] + 3,
                     paged_attn=before["paged_attn"] + 2)
        after["encoded_matmul_by_shape"] = before[
            "encoded_matmul_by_shape"] + collections.Counter({(4, 8, 8): 3})
        after["paged_attn_by_sq"] = before["paged_attn_by_sq"] + \
            collections.Counter({5: 2})
        delta = counts.diff_counts(after, before)
        assert delta == {"encoded_matmul": 3, "paged_attn": 2,
                         "flash_attention": 0,
                         "encoded_matmul_by_shape": {(4, 8, 8): 3},
                         "paged_attn_by_sq": {5: 2}}
        counts.add_counts(delta)
        counts.add_counts(delta)
        now = counts.launch_counts()
        assert now["encoded_matmul"] == before["encoded_matmul"] + 6
        assert now["paged_attn"] == before["paged_attn"] + 4
        assert now["encoded_matmul_by_shape"][(4, 8, 8)] == \
            before["encoded_matmul_by_shape"][(4, 8, 8)] + 6
        assert now["paged_attn_by_sq"][5] == before["paged_attn_by_sq"][5] + 4
        counts.set_launch_counts({})
        zero = counts.launch_counts()
        assert zero["paged_attn"] == 0 and not zero["encoded_matmul_by_shape"]
    finally:
        counts.set_launch_counts(before)
    assert counts.launch_counts() == before


# two kernel nodes and an edge, as ``cudaGraphDebugDotPrint`` (verbose)
# writes them on the H100 machine (func and node handles cut)
_DOT = """digraph dot {
subgraph cluster_1 {
label="graph_1" graph[style="dashed"];
"graph_1_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 1) | _ZN50_GLOBAL__N__9ca351ae_17_encoded_matmul_cu_0ae6f67b21encoded_matmul_kernelILi8EEEvPKaPK13__nv_bfloat16PKfPfiiiiiiNS_9MonoTableE\\<\\<\\<\\{16,8\\},128,52224\\>\\>\\>}
| {cooperative | 0}
}"];

"graph_1_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 0) | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_15CUDAFunctor_addIfEESt5arrayIPcLm3EEEEviT0_T1_\\<\\<\\<4,128,0\\>\\>\\>}
| {cooperative | 0}
}"];

"graph_1_node_0" -> "graph_1_node_1" [headlabel=0];
}
}
"""


def test_graph_kernel_counts_reads_the_nodes():
    """``chip_smoke.graph_kernel_counts`` counts a graph's kernel nodes by
    kind from its dump, and not the edges between them."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    class Dumped:
        def debug_dump(self, path):
            with open(path, "w") as f:
                f.write(_DOT)

    class Unkept:
        def debug_dump(self, path):
            pass

    assert smoke.graph_kernel_counts(Dumped()) == (
        {"encoded_matmul": 1, "paged_attn": 0, "flash_attention": 0}, 2)
    with pytest.raises(AssertionError, match="keep_graph"):
        smoke.graph_kernel_counts(Unkept())
    assert graphs.Step.keep_graph is False


def test_a_registered_counter_is_carried():
    """A wrapper registered after the others is read, set, diffed and
    added with them: nothing outside the registry lists the counters."""
    def new_kernel():
        new_kernel.launches += 1
        new_kernel.by_width[7] += 1

    counts.register(new_kernel, new_kernel_by_width="by_width")
    try:
        before = counts.launch_counts()
        assert before["new_kernel"] == 0 and not before["new_kernel_by_width"]
        new_kernel()
        delta = counts.diff_counts(counts.launch_counts(), before)
        assert delta["new_kernel"] == 1
        assert delta["new_kernel_by_width"] == {7: 1}
        counts.set_launch_counts(before)     # a capture undoes its launches
        assert new_kernel.launches == 0 and not new_kernel.by_width
        # a graph captured before the wrapper registered adds it nothing
        counts.add_counts({k: v for k, v in delta.items()
                           if not k.startswith("new_kernel")})
        assert new_kernel.launches == 0 and not new_kernel.by_width
        counts.add_counts(delta)             # and each replay adds them
        counts.add_counts(delta)
        assert new_kernel.launches == 2 and new_kernel.by_width == {7: 2}
        counts.set_launch_counts({})
        assert new_kernel.launches == 0 and not new_kernel.by_width
        counts.set_launch_counts(before)
    finally:
        counts._COUNTERS.pop("new_kernel")
        counts._COUNTERS.pop("new_kernel_by_width")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_prefix_cache_and_spec_decode_self(capsys):
    base = ["--reduced", "--continuous", "--device", "cpu", "--requests",
            "3", "--max-new", "6", "--paged-attn", "kernel"]
    tcli.main(base)
    plain = capsys.readouterr().out
    tcli.main(base + ["--prefix-cache", "--spec-decode", "3"])
    spec = capsys.readouterr().out
    assert "prefix: hit_rate=" in spec and "spec: k=3" in spec
    assert "drafter=fp" in spec and "jit_compiles=0" in spec
    toks = lambda out: [ln for ln in out.splitlines()  # noqa: E731
                        if ln.startswith("req")]
    assert toks(plain) and toks(spec) == toks(plain)


def test_cli_encoded_drafter(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(TE, "DEFAULT_CACHE_DIR", str(tmp_path))
    argv = ["--reduced", "--continuous", "--device", "cpu", "--requests",
            "2", "--max-new", "4", "--spec-decode", "2", "--draft",
            "encoded", "--draft-m-bits", "24", "--calib-samples", "4",
            "--calib-refine", "4", "--calib-batches", "1"]
    tcli.main(argv)
    out = capsys.readouterr().out
    assert "encoded drafter m_bits=24" in out and "searched+folded" in out
    assert "drafter=encoded_infer" in out


@pytest.mark.parametrize("argv,msg", [
    (["--spec-decode", "2"], "requires --continuous"),
    (["--continuous", "--spec-decode", "-1"], "must be >= 0")])
def test_cli_argument_checks(argv, msg, capsys):
    with pytest.raises(SystemExit):
        tcli.main(["--reduced", "--device", "cpu"] + argv)
    assert msg in capsys.readouterr().err
