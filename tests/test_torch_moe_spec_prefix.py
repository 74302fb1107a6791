"""Port parity for the prefix cache and speculative decoding on the moe
family (reduced qwen3-moe-235b-a22b on the CPU), against the JAX
``Engine``: the shared-prefix trace with the cache on (fp with f32 pools;
the exact encoding with f32, int8 and int4 pools), and speculative
decoding at k = 2 and 4 with the ``self`` and an ``encoded`` drafter (fp
verifier, f32 pools; the exact encoding with int8 and int4 pools).

Every MoE call sizes its expert capacity from its own padded B·S: a
prefill of only the uncached suffix, a draft step (B·1) and a verify
forward (B·(k+1)) route other batches than a plain serve, so the tokens
are held to the reference engine's, not to plain decode's.  Exact: the
scheduler state, page tables and lens after every step, the tokens, the
prefix hits, the acceptance counts, and each MoE call's dropped (token,
choice) pairs, in call order (the reference's counted inside its jitted
steps by a ``jax.debug.callback``, the port's from its dispatch plan).

With quantized pools one limit applies: K/V that f32 summation order
moves by an ulp may round to another int4 (or int8) code where its value
sits on a .5 boundary, and a later MoE call may then route a row to
another expert.  Where the drop counts part, the first K/V code apart
(both packages' ``x / scale`` before rounding, recorded at every
quantize in order) must sit within ``ORIGIN_TOL`` of a .5 boundary on
both sides; tokens, states and acceptance are held exactly regardless.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.nn.moe as JMOE  # noqa: E402
import repro.nn.paged as JPAGED  # noqa: E402
import repro.serve.engine as JENG  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import encoded as JE  # noqa: E402

import repro_torch.nn.moe as TMOE  # noqa: E402
import repro_torch.nn.paged as TPAGED  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import encoded as TE  # noqa: E402
from repro_torch.serve import arch_families, exact_encodings  # noqa: E402

ARCH = "qwen3-moe-235b-a22b"
# the drafter's search at a test's size
DRAFT_OPTS = dict(m_bits=24, n_samples=16, refine=8, calib_batches=2,
                  calib_batch_size=2, calib_seq=32)
SPEC_KEYS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
             "spec_acceptance_rate", "decode_tokens", "prefill_chunks",
             "prefill_tokens", "draft_mac_mode")
# a K/V code apart: x / scale within this of a .5 boundary on both sides
ORIGIN_TOL = 1e-3
PREFIX_KEYS = ("prefix_hit_tokens", "prefix_lookup_tokens",
               "prefix_pages_indexed", "cow_copies", "evictions",
               "prefill_tokens", "prefill_chunks", "decode_tokens",
               "pages_cached", "pages_held", "pages_free")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's torch ops (the suite runs in
    several worker processes on a few cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Reduced qwen3-moe: the reference's params, fp and encoded-exact
    (its own fold), the port's bridged fp params and its own exact fold,
    and an M = 24 encoded drafter the reference searched (the port loads
    its bundle: a cache hit)."""
    jcfg = jget(ARCH).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tget(ARCH).reduced()
    tp = params_from_jax(_to_np(jp), tcfg, "cpu")
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    jpe, jce, _ = JE.prepare_encoded_serving(
        jp, jcfg, macs_override={n: mac for n in arch_families(tcfg)},
        cache_dir=str(tmp_path_factory.mktemp("ref")), verbose=False)
    tpe, tce, _ = TE.prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(families=arch_families(tcfg)),
        cache_dir=str(tmp_path_factory.mktemp("own")), device="cpu",
        verbose=False)
    cache = str(tmp_path_factory.mktemp("drafter"))
    jdp, jdc, _ = JE.prepare_drafter(jp, jcfg, cache_dir=cache,
                                     verbose=False, **DRAFT_OPTS)
    tdp, tdc, info = TE.prepare_drafter(tp, tcfg, cache_dir=cache,
                                        verbose=False, device="cpu",
                                        **DRAFT_OPTS)
    assert info["loaded"]
    return {"fp": ((jp, jcfg), (tp, tcfg)),
            "exact": ((jpe, jce), (tpe, tce)),
            "drafters": {"self": ((None, None), (None, None)),
                         "encoded": ((jdp, jdc), (tdp, tdc))}}


@pytest.fixture
def drops(monkeypatch):
    """Each MoE call's dropped pairs, in call order, of the reference
    (from inside its jitted steps) and of the port, and each K/V
    quantize's ``x / scale`` before rounding.  The reference's memoized
    step jits are dropped first, so its steps trace anew with the
    counters in them."""
    jt, tt, jq, tq = [], [], [], []
    jquant = JPAGED.quantize_kv

    def jq_rec(val, mode):
        f = val.astype(jnp.float32)
        amax = jnp.max(jnp.abs(f), axis=-1)
        lv = 127.0 if mode == "int8" else 7.0
        r = f / (amax / lv + 1e-12)[..., None]
        jax.debug.callback(lambda v: jq.append(np.asarray(v)), r,
                           ordered=True)
        return jquant(val, mode)
    monkeypatch.setattr(JPAGED, "quantize_kv", jq_rec)
    tquant = TPAGED.quantize_kv

    def tq_rec(val, mode):
        f = val.to(torch.float32)
        lv = 127.0 if mode == "int8" else 7.0
        s_ = f.abs().amax(-1) / lv
        tq.append((f / (s_[..., None] + 1e-12)).numpy().copy())
        return tquant(val, mode)
    monkeypatch.setattr(TPAGED, "quantize_kv", tq_rec)
    orig = JMOE.dispatch_compute

    def counted(x2, idx, w, wi, wg, wo, *, n_experts_total, capacity, act,
                axis_name):
        cnt = jnp.bincount(idx.reshape(-1), length=n_experts_total)
        lost = idx.size - jnp.minimum(cnt, capacity).sum()
        jax.debug.callback(lambda v: jt.append(int(v)), lost, ordered=True)
        return orig(x2, idx, w, wi, wg, wo, n_experts_total=n_experts_total,
                    capacity=capacity, act=act, axis_name=axis_name)
    monkeypatch.setattr(JMOE, "dispatch_compute", counted)
    plan = TMOE.dispatch_plan

    def tcounted(idx, n_experts, cap):
        out = plan(idx, n_experts, cap)
        tt.append(int((~out[2]).sum()))
        return out
    monkeypatch.setattr(TMOE, "dispatch_plan", tcounted)
    JENG._jitted_paged_steps_cached.cache_clear()
    JENG._jitted_spec_steps_cached.cache_clear()
    yield jt, tt, jq, tq
    JENG._jitted_paged_steps_cached.cache_clear()
    JENG._jitted_spec_steps_cached.cache_clear()


def _edge(v: float) -> float:
    return abs(v - (np.floor(v) + 0.5))


def _check_drops(drops, kv):
    """Drop counts equal call for call; or, with quantized pools, parted
    after a K/V code that f32 order moved across a .5 boundary."""
    jt, tt, jq, tq = drops
    assert len(tt) == len(jt) > 0
    if tt == jt:
        return
    first = next(i for i, (a, b) in enumerate(zip(jt, tt)) if a != b)
    assert kv != "bf16", f"f32 pools: drops part at MoE call {first}"
    assert len(jq) == len(tq)
    lv = 127 if kv == "int8" else 7
    for i, (a, b) in enumerate(zip(jq, tq)):
        ca = np.clip(np.round(a), -lv, lv)
        cb = np.clip(np.round(b), -lv, lv)
        apart = np.flatnonzero(ca.ravel() != cb.ravel())
        if apart.size:
            u, v = float(a.ravel()[apart[0]]), float(b.ravel()[apart[0]])
            print(f"drops part at MoE call {first}; first K/V code apart "
                  f"at quantize {i}: {u!r} / {v!r}")
            assert max(_edge(u), _edge(v)) <= ORIGIN_TOL, (u, v)
            return
    raise AssertionError(f"drops part at MoE call {first} with every K/V "
                         "code equal")


def _cfgs(jcfg, tcfg, kv):
    return (dataclasses.replace(jcfg, kv_cache_dtype=kv,
                                attention_backend="pallas"),
            dataclasses.replace(tcfg, kv_cache_dtype=kv,
                                attention_backend="kernel"))


def _state(eng):
    reqs = tuple((rid, r.state, r.slot, r.n_cached, tuple(r.pages),
                  tuple(r.out), r.n_evictions)
                 for rid, r in sorted(eng.requests.items()))
    slots = tuple(None if r is None else r.rid for r in eng.sched.slots)
    return reqs, slots, tuple(r.rid for r in eng.sched.queue)


def _lockstep(je, te, waves, max_new):
    """Both engines through ``waves`` ({step: prompts}), step by step:
    the scheduler state, page tables and lens equal after every step."""
    step = 0
    while step in waves or je.busy or te.busy:
        for p in waves.get(step, []):
            assert je.submit(p, max_new=max_new) == \
                te.submit(p, max_new=max_new)
        je.step()
        te.step()
        step += 1
        assert _state(te) == _state(je), f"step {step}"
        np.testing.assert_array_equal(te.kv.ptab, je.kv.ptab)
        np.testing.assert_array_equal(te.kv.lens, je.kv.lens)
        assert step < 400
    jr, tr = je.results(), te.results()
    assert sorted(jr) == sorted(tr)
    for rid in jr:
        assert tr[rid].tolist() == jr[rid].tolist(), rid
    return je.stats(), te.stats()


def _shared_prefix_waves(vocab: int):
    """Three waves: a 13-token shared prefix with suffixes of 2–9 tokens,
    one prompt repeated exactly, one unrelated prompt."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, 13).astype(np.int32)
    tail = lambda n: rng.integers(0, vocab, n).astype(np.int32)  # noqa
    p = [np.concatenate([shared, tail(n)]) for n in (3, 7, 2, 9)]
    return {0: [p[0], p[1]], 3: [p[2], tail(6)], 8: [p[3], p[0].copy()]}


@pytest.mark.parametrize("mode,kv", [("fp", "bf16"), ("exact", "bf16"),
                                     ("exact", "int8"), ("exact", "int4")])
def test_shared_prefix_trace_matches_reference(models, mode, kv, drops):
    (jp, jcfg), (tp, tcfg) = models[mode]
    jcfg, tcfg = _cfgs(jcfg, tcfg, kv)
    kw = dict(n_slots=2, page_size=4, n_pages=16, max_seq_pages=8,
              reserve="optimistic", prefill_chunk=8, prefix_cache=True)
    js, ts = _lockstep(JEngine(jp, jcfg, **kw),
                       TEngine(tp, tcfg, device="cpu", **kw),
                       _shared_prefix_waves(tcfg.vocab_size), 8)
    assert {k: ts[k] for k in PREFIX_KEYS} == {k: js[k] for k in PREFIX_KEYS}
    assert ts["prefix_hit_tokens"] > 0
    _check_drops(drops, kv)
    assert sum(drops[1]) > 0


def _spec_prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).astype(np.int32)
            for n in (5, 12, 9, 3, 14)]


@pytest.mark.parametrize("mode,kv,drafter,k", [
    ("fp", "bf16", "self", 2), ("fp", "bf16", "self", 4),
    ("fp", "bf16", "encoded", 2), ("fp", "bf16", "encoded", 4),
    ("exact", "int8", "self", 4), ("exact", "int4", "self", 4)])
def test_spec_decode_matches_reference(models, mode, kv, drafter, k, drops):
    """Draft + verify rounds step by step: tokens, acceptance and drops as
    the reference's.  With the self drafter, acceptance stays below 1
    wherever a draft step and the verify forward drop other pairs."""
    (jp, jcfg), (tp, tcfg) = models[mode]
    jcfg, tcfg = _cfgs(jcfg, tcfg, kv)
    (jdp, jdc), (tdp, tdc) = models["drafters"][drafter]
    if jdc is not None:
        jdc = dataclasses.replace(jdc, kv_cache_dtype=kv,
                                  attention_backend="pallas")
        tdc = dataclasses.replace(tdc, kv_cache_dtype=kv,
                                  attention_backend="kernel")
    kw = dict(n_slots=2, page_size=4, n_pages=48, prefill_chunk=8,
              spec_decode=k)
    je = JEngine(jp, jcfg, draft_params=jdp, draft_cfg=jdc, **kw)
    te = TEngine(tp, tcfg, draft_params=tdp, draft_cfg=tdc, device="cpu",
                 **kw)
    js, ts = _lockstep(je, te, {0: _spec_prompts(tcfg.vocab_size)}, 10)
    assert {x: ts[x] for x in SPEC_KEYS} == {x: js[x] for x in SPEC_KEYS}
    assert ts["spec_rounds"] > 0 and ts["spec_decode_k"] == k
    _check_drops(drops, kv)
    assert sum(drops[1]) > 0


def test_prefix_cache_and_spec_together_match_reference(models, drops):
    """Spec decoding k = 4 over the shared-prefix trace with the cache
    on, chunked prefill of the uncached suffix."""
    (jp, jcfg), (tp, tcfg) = models["fp"]
    kw = dict(n_slots=2, page_size=4, n_pages=24, prefill_chunk=8,
              prefix_cache=True, spec_decode=4)
    js, ts = _lockstep(JEngine(jp, jcfg, **kw),
                       TEngine(tp, tcfg, device="cpu", **kw),
                       _shared_prefix_waves(tcfg.vocab_size), 8)
    keys = SPEC_KEYS + ("prefix_hit_tokens", "cow_copies")
    assert {x: ts[x] for x in keys} == {x: js[x] for x in keys}
    assert ts["prefix_hit_tokens"] > 0
    _check_drops(drops, "bf16")
