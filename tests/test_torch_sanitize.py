"""Port parity for the allocator sanitizer (``repro_torch.analysis.ledger``:
the shadow page ledger, ``PagedKVCache(sanitize=)``, ``REPRO_SANITIZE``)
and for ``launch/env.py:set_debug_nan``, against the JAX package's
ledger and ``jax_debug_nans``: the reference's ledger tests on the
port's allocator, seeded random sequences of allocator and page-table
operations through both ledgers (the same verdict at the same
operation), and a sanitized serve with the prefix cache and a
copy-on-write (reduced qwen1.5-0.5b, CPU)."""
import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import ledger as jled  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import paged_cache as jpc  # noqa: E402

from repro_torch.analysis import ledger as tled  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch.env import set_debug_nan  # noqa: E402
from repro_torch.models import apply_model as t_apply  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve import paged_cache as tpc  # noqa: E402
from repro_torch.serve.scheduler import DECODING  # noqa: E402

LedgerError = tled.LedgerError


@pytest.fixture(scope="module")
def models():
    jcfg = jget("qwen1.5-0.5b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tget("qwen1.5-0.5b").reduced()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    return (jp, jcfg), (tp, tcfg)


def _tiny_kv(**kw):
    cfg = tget("qwen1.5-0.5b").reduced()
    return tpc.PagedKVCache(cfg, n_slots=2, n_pages=8, page_size=8,
                            max_seq_pages=4, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the reference's ledger tests on the port's allocator
# ---------------------------------------------------------------------------

def test_ledger_double_free_rejected():
    kv = _tiny_kv(sanitize=True)
    pages = kv.alloc.alloc(2)
    kv.alloc.free(pages)
    with pytest.raises(LedgerError, match="free"):
        kv.alloc.free(pages)


def test_ledger_use_after_free_rejected():
    kv = _tiny_kv(sanitize=True)
    pages = kv.alloc.alloc(1)
    kv.alloc.free(pages)
    with pytest.raises(LedgerError):
        kv.set_pages(0, pages)


def test_ledger_copy_to_unowned_page_rejected():
    kv = _tiny_kv(sanitize=True)
    pages = kv.alloc.alloc(1)
    with pytest.raises(LedgerError):
        kv.copy_page(pages[0], pages[0] + 1)


def test_ledger_rejection_leaves_shadow_intact():
    kv = _tiny_kv(sanitize=True)
    a = kv.alloc.alloc(2)
    kv.alloc.free(a[:1])
    with pytest.raises(LedgerError):
        kv.alloc.free(a)                 # batch contains the freed page
    kv.alloc.free(a[1:])                 # still-held page frees cleanly
    kv.ledger.verify()
    assert kv.ledger.ops > 0 and kv.ledger.checks > 0


def test_sanitize_env_default(monkeypatch, models):
    _, (tp, tcfg) = models
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    assert tled.sanitize_enabled() and jled.sanitize_enabled()
    assert _tiny_kv().ledger is None     # explicit opt-in only: stays off
    assert TEngine(tp, tcfg, device="cpu").kv.ledger is not None
    assert TEngine(tp, tcfg, device="cpu", sanitize=False).kv.ledger is None
    for off in ("0", "", "no"):
        monkeypatch.setenv("REPRO_SANITIZE", off)
        assert not tled.sanitize_enabled()
    assert TEngine(tp, tcfg, device="cpu").kv.ledger is None


# ---------------------------------------------------------------------------
# random operation sequences: the same verdict at the same operation
# ---------------------------------------------------------------------------

def _random_ops(seed, n_pages, n_ops=160):
    """Allocator and page-table operations with random (often invalid)
    arguments: page ids from the whole pool, scratch page 0 and one past
    it included."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["alloc", "retain", "free", "mark", "unmark",
                           "set_pages", "set_len", "copy_page"],
                          p=[.2, .12, .2, .1, .06, .12, .12, .08])
        page = lambda: int(rng.integers(0, n_pages + 1))  # noqa: E731
        if kind == "alloc":
            ops.append((kind, int(rng.integers(0, 4))))
        elif kind in ("retain", "mark", "unmark"):
            ops.append((kind, page()))
        elif kind == "free":
            ops.append((kind, [page() for _ in range(rng.integers(1, 4))]))
        elif kind == "set_pages":
            ops.append((kind, int(rng.integers(0, 2)),
                        [page() for _ in range(rng.integers(0, 4))]))
        elif kind == "set_len":
            ops.append((kind, int(rng.integers(0, 2)),
                        int(rng.integers(-1, 30))))
        else:
            ops.append((kind, page(), page()))
    return ops


def _replay(kv, ops):
    """Each operation's outcome: its result, or the error it raised (the
    ledger's findings and the allocator's own), then the state after it."""
    al, out = kv.alloc, []
    for op in ops:
        kind, args = op[0], op[1:]
        try:
            if kind == "alloc":
                res = al.alloc(*args)
            elif kind == "retain":
                res = al.retain(*args)
            elif kind == "free":
                res = al.free(*args)
            elif kind == "mark":
                res = al.mark_cached(*args)
            elif kind == "unmark":
                res = al.unmark_cached(*args)
            else:
                res = getattr(kv, kind)(*args)
            res = ("ok", res)
        except LedgerError as e:
            res = ("LedgerError", str(e))
        except jled.LedgerError as e:
            res = ("LedgerError", str(e))
        except (ValueError, IndexError, KeyError) as e:
            res = (type(e).__name__, str(e))
        out.append((op, res, sorted(al._free), dict(al._ref),
                    list(al._cached), kv.ptab.tolist(), kv.lens.tolist()))
    kv.ledger.verify()
    return out


@pytest.mark.parametrize("seed", range(6))
def test_random_ops_give_the_references_verdicts(models, seed):
    (_, jcfg), (_, tcfg) = models
    kw = dict(n_slots=2, n_pages=9, page_size=4, max_seq_pages=4,
              sanitize=True)
    ops = _random_ops(seed, 9)
    want = _replay(jpc.PagedKVCache(jcfg, **kw), ops)
    got = _replay(tpc.PagedKVCache(tcfg, device="cpu", **kw), ops)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"op {i}: {ops[i]}"
    assert any(r[1][0] == "LedgerError" for r in got)
    assert any(r[1][0] == "ok" and r[0][0] == "copy_page" for r in got) or \
        seed % 2


# ---------------------------------------------------------------------------
# a sanitized serve with the prefix cache and a copy-on-write
# ---------------------------------------------------------------------------

def _serve_cow(eng_cls, params, cfg, prompts, **kw):
    """Prompts with a shared prefix served one wave at a time; once the
    third request decodes inside a page, a peer takes a reference to that
    page, so its next write must copy it (the peer lets go at the end)."""
    eng = eng_cls(params, cfg, n_slots=2, page_size=4, n_pages=20,
                  prefix_cache=True, prefill_chunk=8, **kw)
    outs, peer = [], None
    for p in prompts:
        rid = eng.submit(p, max_new=6)
        while eng.busy:
            eng.step()
            r = eng.requests[rid]
            if rid == 2 and peer is None and r.state == DECODING \
                    and r.n_cached % 4:
                peer = r.pages[r.n_cached // 4]
                eng.kv.alloc.retain(peer)
        outs.append(eng.results()[rid].tolist())
    eng.kv.alloc.free([peer])
    return outs, eng


def test_sanitized_serve_with_cow_matches(models):
    (jp, jcfg), (tp, tcfg) = models
    rng = np.random.default_rng(7)
    shared = rng.integers(0, tcfg.vocab_size, 9).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(
        0, tcfg.vocab_size, n).astype(np.int32)]) for n in (4, 2, 5)]
    plain, _ = _serve_cow(TEngine, tp, tcfg, prompts, device="cpu",
                          sanitize=False)
    out, eng = _serve_cow(TEngine, tp, tcfg, prompts, device="cpu",
                          sanitize=True)
    ref, jeng = _serve_cow(JEngine, jp, jcfg, prompts, sanitize=True)
    assert out == plain == ref
    st, jst = eng.stats(), jeng.stats()
    assert st["cow_copies"] == jst["cow_copies"] == 1
    assert st["prefix_hit_tokens"] == jst["prefix_hit_tokens"] > 0
    led = eng.kv.ledger
    assert led.checks >= st["steps"] and led.ops > 0
    assert (led.ops, led.checks) == (jeng.kv.ledger.ops,
                                     jeng.kv.ledger.checks)
    led.verify()


def test_engine_catches_a_foreign_free(models):
    """A page freed behind the scheduler's back is a finding at the next
    operation that names it, before the allocator changes."""
    _, (tp, tcfg) = models
    eng = TEngine(tp, tcfg, n_slots=1, page_size=4, n_pages=12,
                  device="cpu", sanitize=True)
    eng.submit(np.arange(6, dtype=np.int32), max_new=4)
    eng.step()
    page = eng.requests[0].pages[0]
    eng.kv.alloc.free([page])
    before = copy.deepcopy(eng.kv.alloc._ref)
    with pytest.raises(LedgerError):
        eng.run()
    assert eng.kv.alloc._ref == before


# ---------------------------------------------------------------------------
# set_debug_nan
# ---------------------------------------------------------------------------

def _nan_params(models):
    """Both packages' params with one NaN in layer 0's ``wq``."""
    (jp, jcfg), (tp, tcfg) = models
    jp = jax.tree_util.tree_map(lambda a: a, jp)
    wq = np.asarray(jp["stack"]["attn"]["wq"]).copy()
    wq[0, 3, 5] = np.nan
    jp["stack"]["attn"] = dict(jp["stack"]["attn"], wq=jnp.asarray(wq))
    tp = dict(tp, layers=[dict(layer) for layer in tp["layers"]])
    tp["layers"][0]["attn"] = dict(tp["layers"][0]["attn"])
    w = tp["layers"][0]["attn"]["wq"].clone()
    w[3, 5] = float("nan")
    tp["layers"][0]["attn"]["wq"] = w
    return (jp, jcfg), (tp, tcfg)


def test_debug_nan_names_the_linear(models):
    (jp, jcfg), (tp, tcfg) = _nan_params(models)
    toks = np.arange(5, dtype=np.int32)[None]
    # flag off: the NaN passes, as in the reference
    lg, _ = t_apply(tp, tcfg, torch.from_numpy(toks))
    assert torch.isnan(lg).any()
    assert np.isnan(np.asarray(j_apply(jp, jcfg, jnp.asarray(toks))[0])).any()
    set_debug_nan(True)
    try:
        with pytest.raises(FloatingPointError, match="linear 'wq'"):
            t_apply(tp, tcfg, torch.from_numpy(toks))
        # clean params still serve under the flag, eagerly
        _, (tp0, tcfg0) = models
        t_apply(tp0, tcfg0, torch.from_numpy(toks))
        assert tengine._graphs_on(torch.device("cuda"), None) is False
        with pytest.raises(ValueError, match="debug_nan"):
            tengine._graphs_on(torch.device("cuda"), True)
    finally:
        set_debug_nan(False)
    assert tengine._graphs_on(torch.device("cuda"), None) is True
    jax.config.update("jax_debug_nans", True)
    try:
        with pytest.raises(FloatingPointError):
            j_apply(jp, jcfg, jnp.asarray(toks))
    finally:
        jax.config.update("jax_debug_nans", False)
