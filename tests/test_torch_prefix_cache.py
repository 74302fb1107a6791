"""Port parity for prefix caching (``PrefixIndex``, copy-on-write
``PagedKVCache.copy_page``, ``Scheduler(prefix_cache=)`` with
``note_prefilled`` and ``ensure_write_window``): the same operations and
the same shared-prefix traces through the reference and the port (reduced
qwen1.5-0.5b on the CPU).  Host decisions must match exactly: chain keys
byte for byte, matches, hit counts, page tables, admissions and
copy-on-write copies; greedy tokens token for token."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402
from repro.serve import scheduler as jsch  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import paged_cache as tpc  # noqa: E402
from repro_torch.serve import scheduler as tsch  # noqa: E402


@pytest.fixture(scope="module")
def models():
    jcfg = jget("qwen1.5-0.5b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tget("qwen1.5-0.5b").reduced()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return (jp, jcfg), (tp, tcfg)


# ---------------------------------------------------------------------------
# the index and the allocator: one transcript through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ps", [1, 4, 16])
@pytest.mark.parametrize("n", [0, 3, 16, 37])
def test_chain_keys_are_the_references(ps, n):
    toks = np.random.default_rng(n + ps).integers(
        -2 ** 31, 2 ** 31 - 1, n, dtype=np.int64).astype(np.int32)
    want = jpc.PrefixIndex(jpc.PageAllocator(4), ps).chain_keys(toks)
    got = tpc.PrefixIndex(tpc.PageAllocator(4), ps).chain_keys(toks)
    assert len(got) == n // ps and got == want
    assert all(isinstance(k, bytes) and len(k) == 32 for k in got)


def _match_leaves_a_token(m):
    al = m.PageAllocator(32)
    idx = m.PrefixIndex(al, page_size=4)
    toks = np.arange(16, dtype=np.int32)
    pages = al.alloc(4)
    out = [idx.insert(toks, pages)]
    al.free(pages)
    got = idx.match(toks)                       # the last page re-prefills
    out += [got, [al.refcount(p) for p in got]]
    al.free(got)
    got = idx.match(np.arange(20, dtype=np.int32))
    out.append(got)
    al.free(got)
    return out


def _divergent_chain(m):
    al = m.PageAllocator(32)
    idx = m.PrefixIndex(al, page_size=4)
    toks = np.arange(12, dtype=np.int32)
    pages = al.alloc(3)
    idx.insert(toks, pages)
    out = []
    for pos in (1, 5, 11):
        other = toks.copy()
        other[pos] = 99
        got = idx.match(other, 12)
        out.append(got)
        al.free(got)
    return out


def _tail_first_eviction(m):
    al = m.PageAllocator(8)
    idx = m.PrefixIndex(al, page_size=4)
    toks = np.arange(12, dtype=np.int32)
    pages = al.alloc(3)
    idx.insert(toks, pages)
    al.free(pages)
    got = al.alloc(6)
    out = [pages, got, idx.match(toks, 12), len(idx), al.n_cached]
    return out


def _dropped_entries(m):
    al = m.PageAllocator(8)
    idx = m.PrefixIndex(al, page_size=4)
    toks = np.arange(8, dtype=np.int32)
    pages = al.alloc(2)
    idx.insert(toks, pages)
    al.free(pages)
    out = [al.n_cached, len(idx)]
    out += [al.alloc(7), len(idx), idx.match(toks, 8), al.n_free]
    return out


def _hit_window(m):
    al = m.PageAllocator(64)
    idx = m.PrefixIndex(al, page_size=4)
    out = []
    for i in range(40):
        idx.record(i % 3, 4 + i)
        out.append((idx.hit_rate, idx.windowed_hit_rate))
    return out + [idx.hit_tokens, idx.lookup_tokens]


@pytest.mark.parametrize("scenario", [_match_leaves_a_token,
                                      _divergent_chain,
                                      _tail_first_eviction,
                                      _dropped_entries, _hit_window])
def test_index_and_allocator_transcripts_are_the_references(scenario):
    assert scenario(tpc) == scenario(jpc)


# ---------------------------------------------------------------------------
# the scheduler: admissions, blocked admissions, write windows
# ---------------------------------------------------------------------------

def _kv_pair(models, **kw):
    (_, jcfg), (_, tcfg) = models
    return (jpc.PagedKVCache(jcfg, **kw),
            tpc.PagedKVCache(tcfg, device="cpu", **kw))


def _sched_state(s):
    al = s.kv.alloc
    reqs = [None if r is None else (r.rid, r.state, tuple(r.pages),
                                    r.n_cached) for r in s.slots]
    return (reqs, [r.rid for r in s.queue], s.kv.ptab.tolist(),
            s.kv.lens.tolist(), al.n_free_strict, al.n_cached, al.n_held,
            s.n_cow_copies, s.n_evictions,
            (s.prefix.hit_tokens, s.prefix.lookup_tokens, len(s.prefix))
            if s.prefix is not None else None)


def test_blocked_admissions_do_not_inflate_hits(models):
    """A head-of-line request re-matched while it waits for pages commits
    its hit and lookup counts once, when it is admitted."""
    states = []
    for kv, m in zip(_kv_pair(models, n_slots=2, n_pages=5, page_size=4,
                              max_seq_pages=4), (jsch, tsch)):
        s = m.Scheduler(kv, prefix_cache=True)
        r1 = m.Request(rid=0, prompt=np.zeros(8, np.int32), max_new=4)
        r2 = m.Request(rid=1, prompt=np.zeros(8, np.int32), max_new=4)
        s.submit(r1)
        s.submit(r2)
        trans = [[r.rid for _, r in s.admissions()]]
        for _ in range(5):
            trans.append([r.rid for _, r in s.admissions()])
        trans.append(_sched_state(s))
        r1.state = m.DECODING
        s.note_prefilled(r1)
        s.finish(r1, 1.0)
        trans += [[r.rid for _, r in s.admissions()], _sched_state(s)]
        states.append(trans)
    assert states[1] == states[0]
    assert states[1][-1][-1][1] == 16           # each lookup counted once


def _window_scenario(m, kv):
    """Growth, copy-on-write of a shared page, a window that cannot be
    served without evicting a younger request, and one that cannot be
    served at all: each call's answer and the state after it."""
    s = m.Scheduler(kv, reserve="optimistic", prefix_cache=True)
    old = m.Request(rid=0, prompt=np.arange(10, dtype=np.int32),
                    max_new=20, t_arrive=0.0)
    young = m.Request(rid=1, prompt=np.arange(5, dtype=np.int32) + 50,
                      max_new=20, t_arrive=1.0)
    s.submit(old)
    s.submit(young)
    trans = [[r.rid for _, r in s.admissions()], _sched_state(s)]
    for r in (old, young):
        r.n_cached = r.plen
        r.state = m.DECODING
        s.note_prefilled(r)
        r.out = [1]
    kv.alloc.retain(old.pages[2])       # a peer shares the page at 8..11
    for req, n in ((old, 1), (old, 3), (old, 6), (young, 4), (young, 20),
                   (old, 13), (young, 2), (old, 40)):
        if req.state != m.DECODING:
            trans.append(("not decoding", req.rid))
            continue
        try:
            ok = s.ensure_write_window(req, n)
        except RuntimeError as e:       # the pool cannot hold req alone
            ok = f"raised: {'exhausted' in str(e)}"
        trans += [(req.rid, n, ok), _sched_state(s)]
    return trans


def test_write_window_decisions_are_the_references(models):
    jkv, tkv = _kv_pair(models, n_slots=2, n_pages=9, page_size=4,
                        max_seq_pages=8)
    rng = np.random.default_rng(0)
    for st in tkv.layers:               # distinct pages, to follow copies
        for t in st.values():
            t.copy_(torch.from_numpy(rng.normal(size=t.shape).astype(
                np.float32)).to(t.dtype))
    want = _window_scenario(jsch, jkv)
    got = _window_scenario(tsch, tkv)
    assert got == want
    assert tkv is not None and got[3][-3] == 1   # one copy-on-write
    assert any(isinstance(x, tuple) and x[2] is False for x in got)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_copy_page_in_place_with_scale_rows(models, mode):
    """``copy_page`` duplicates one page of every pool, scale rows
    included, in place: no tensor is replaced and no other page moves;
    the reference's copy gives the same pools."""
    (_, jcfg), (_, tcfg) = models
    kw = dict(n_slots=2, n_pages=6, page_size=4, max_seq_pages=4)
    jkv = jpc.PagedKVCache(dataclasses.replace(jcfg, kv_cache_dtype=mode),
                           **kw)
    tkv = tpc.PagedKVCache(dataclasses.replace(tcfg, kv_cache_dtype=mode),
                           device="cpu", **kw)
    rng = np.random.default_rng(1)
    want_names = {"pool_k", "pool_v"} | (
        set() if mode == "bf16" else {"scale_k", "scale_v"})
    jlayers = {}
    for i, st in enumerate(tkv.layers):
        assert set(st) == want_names
        for name, t in st.items():
            if t.dtype.is_floating_point:
                a = rng.normal(size=t.shape).astype(np.float32)
            else:
                a = rng.integers(0, 120, t.shape)
            t.copy_(torch.from_numpy(a).to(t.dtype))
            jlayers.setdefault(name, []).append(t.numpy().copy())
    jkv.layers = {"stack": {k: jax.numpy.asarray(np.stack(v))
                            for k, v in jlayers.items()}}
    ptrs = [t.data_ptr() for st in tkv.layers for t in st.values()]
    before = [t.clone() for st in tkv.layers for t in st.values()]
    tkv.copy_page(1, 4)
    jkv.copy_page(1, 4)
    assert [t.data_ptr() for st in tkv.layers for t in st.values()] == ptrs
    for t, b in zip((t for st in tkv.layers for t in st.values()), before):
        assert torch.equal(t[4], b[1])
        keep = [p for p in range(6) if p != 4]
        assert torch.equal(t[keep], b[keep])
    for i, st in enumerate(tkv.layers):
        for name, t in st.items():
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jkv.layers["stack"][name][i]))


def test_upload_fills_the_static_buffers(models):
    """The decode step copies the host page table and lens, with its
    tokens, into one device buffer of its own (one copy per call), the
    same tensors on every call (a captured graph reads their addresses)."""
    tp, tcfg = models[1]
    eng = TEngine(tp, tcfg, n_slots=3, page_size=4, n_pages=9,
                  max_seq_pages=5, device="cpu")
    tkv, step = eng.kv, eng.steps["decode"]
    tkv.set_pages(1, [3, 4, 7])
    tkv.set_len(1, 10)
    tkv.set_len(2, 2)
    tokens = np.zeros((3, 1), np.int32)
    step(tokens, tkv.ptab, tkv.lens)
    toks, pages_buf, lens_buf = (step.arg(i) for i in range(3))
    assert pages_buf.dtype == lens_buf.dtype == torch.int32
    assert pages_buf.tolist() == tkv.ptab.tolist()
    assert lens_buf.tolist() == [0, 10, 2]
    assert pages_buf.data_ptr() == toks.data_ptr() + toks.numel() * 4
    assert lens_buf.data_ptr() == pages_buf.data_ptr() + tkv.ptab.size * 4
    tkv.set_pages(2, [5])
    tkv.set_len(2, 3)
    step(tokens + 1, tkv.ptab, tkv.lens)
    assert step.arg(1) is pages_buf and step.arg(2) is lens_buf
    assert pages_buf.tolist() == tkv.ptab.tolist()
    assert lens_buf.tolist() == [0, 10, 3]
    assert not hasattr(tkv, "upload")


# ---------------------------------------------------------------------------
# engines: shared-prefix traces replayed through both
# ---------------------------------------------------------------------------

def _shared_prefix_trace(vocab: int):
    """Three waves of requests: a 13-token shared prefix with suffixes of
    2–9 tokens, one prompt repeated exactly, one unrelated prompt."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, vocab, 13).astype(np.int32)
    tail = lambda n: rng.integers(0, vocab, n).astype(np.int32)  # noqa
    p = [np.concatenate([shared, tail(n)]) for n in (3, 7, 2, 9)]
    return {0: [p[0], p[1]], 3: [p[2], tail(6)],
            8: [p[3], p[0].copy()]}


def _state(eng):
    reqs = tuple((rid, r.state, r.slot, r.n_cached, tuple(r.pages),
                  tuple(r.out), r.n_evictions)
                 for rid, r in sorted(eng.requests.items()))
    slots = tuple(None if r is None else r.rid for r in eng.sched.slots)
    return reqs, slots, tuple(r.rid for r in eng.sched.queue)


STAT_KEYS = ("prefix_hit_tokens", "prefix_lookup_tokens", "prefix_hit_rate",
             "prefix_windowed_hit_rate", "prefix_pages_indexed",
             "cow_copies", "evictions", "prefill_tokens", "prefill_chunks",
             "decode_tokens", "pages_cached", "pages_held", "pages_free")


@pytest.mark.parametrize("backend,mode,reserve", [
    ("gather", "bf16", "optimistic"), ("kernel", "bf16", "conservative"),
    ("kernel", "int8", "optimistic"), ("kernel", "int4", "optimistic")])
def test_shared_prefix_trace_matches_reference(models, backend, mode,
                                               reserve):
    (jp, jcfg), (tp, tcfg) = models
    jcfg = dataclasses.replace(
        jcfg, attention_backend="xla" if backend == "gather" else "pallas",
        kv_cache_dtype=mode)
    tcfg = dataclasses.replace(tcfg, attention_backend=backend,
                               kv_cache_dtype=mode)
    kw = dict(n_slots=2, page_size=4, n_pages=14, max_seq_pages=8,
              reserve=reserve, prefill_chunk=8, prefix_cache=True)
    je = JEngine(jp, jcfg, **kw)
    te = TEngine(tp, tcfg, device="cpu", **kw)
    waves = _shared_prefix_trace(tcfg.vocab_size)
    step = 0
    while step in waves or je.busy or te.busy:
        for p in waves.get(step, []):
            assert je.submit(p, max_new=8) == te.submit(p, max_new=8)
        je.step()
        te.step()
        step += 1
        assert _state(te) == _state(je), f"step {step}"
        np.testing.assert_array_equal(te.kv.ptab, je.kv.ptab)
        np.testing.assert_array_equal(te.kv.lens, je.kv.lens)
        assert te.sched.n_admissions == je.sched._c_admissions.total()
        assert step < 300
    js, ts = je.stats(), te.stats()
    assert {k: ts[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    assert ts["prefix_hit_tokens"] > 0 and ts["prefix_cache"] is True
    jr, tr = je.results(), te.results()
    assert sorted(tr) == sorted(jr) == list(range(6))
    for rid in jr:
        assert tr[rid].tolist() == jr[rid].tolist(), rid


@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_cache_hit_tokens_identical_to_cold(models, backend):
    """Prompts served one after another: later ones hit the first one's
    pages, prefill fewer tokens and give the cold engine's tokens."""
    _, (tp, tcfg) = models
    tcfg = dataclasses.replace(tcfg, attention_backend=backend)
    rng = np.random.default_rng(3)
    shared = rng.integers(0, tcfg.vocab_size, 20).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, tcfg.vocab_size, n).astype(np.int32)]) for n in (3, 6, 4)]

    def serve(prefix_cache):
        eng = TEngine(tp, tcfg, n_slots=2, page_size=4, n_pages=64,
                      prefix_cache=prefix_cache, prefill_chunk=8,
                      device="cpu")
        outs = []
        for p in prompts:
            rid = eng.submit(p, max_new=6)
            outs.append(eng.run()[rid].tolist())
        return outs, eng.stats()

    cold, st_cold = serve(False)
    warm, st_warm = serve(True)
    assert warm == cold
    assert st_cold["prefix_hit_tokens"] == 0 and not st_cold["prefix_cache"]
    assert st_warm["prefix_hit_tokens"] == 2 * 20
    assert st_warm["prefill_tokens"] == st_cold["prefill_tokens"] - 40
    assert st_warm["jit_compiles"] == 0 and not st_warm["cuda_graphs"]
