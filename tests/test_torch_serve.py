"""Port parity for continuous-batching serving: the same trace replayed
through the reference ``Engine`` and the port's ``Engine`` (reduced
qwen1.5-0.5b, optimistic reserve over a pool small enough to force an
eviction, prompts longer than one prefill chunk).  Admissions, evictions,
page tables and lens must match after every step, and greedy outputs
token for token, in fp and in encoded-exact mode."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.obs import percentile  # noqa: E402
from repro_torch.serve import (Engine as TEngine, exact_encodings,  # noqa: E402
                               prepare_encoded_serving)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jcfg = jget("qwen1.5-0.5b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    override = {n: mac for n in ("wq", "wk", "wv", "wo", "wi", "wg", "w")}
    jpe, jce, _ = j_prepare(jp, jcfg, macs_override=override,
                            cache_dir=str(tmp_path_factory.mktemp("b")),
                            verbose=False)
    tcfg = tget("qwen1.5-0.5b").reduced()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    # the port calibrates and folds on its own: serving parity then also
    # covers its calibration stream and fold
    tpe, tce, _ = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(), device="cpu",
        cache_dir=str(tmp_path_factory.mktemp("own")), verbose=False)
    return {"fp": ((jp, jcfg), (tp, tcfg)),
            "encoded": ((jpe, jce), (tpe, tce))}


def _trace():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (40, 13, 35, 7, 50)]


def _state(eng):
    reqs = tuple((rid, r.state, r.slot, r.n_cached, tuple(r.pages),
                  tuple(r.out), r.n_evictions)
                 for rid, r in sorted(eng.requests.items()))
    slots = tuple(None if r is None else r.rid for r in eng.sched.slots)
    queue = tuple(r.rid for r in eng.sched.queue)
    return reqs, slots, eng.sched.n_evictions, queue


@pytest.mark.parametrize("mode,backend", [("fp", "gather"),
                                          ("fp", "kernel"),
                                          ("encoded", "gather"),
                                          ("encoded", "kernel")])
def test_trace_replay_matches_reference(models, mode, backend):
    (jp, jcfg), (tp, tcfg) = models[mode]
    jcfg = dataclasses.replace(
        jcfg, attention_backend="xla" if backend == "gather" else "pallas")
    tcfg = dataclasses.replace(tcfg, attention_backend=backend)
    kw = dict(n_slots=3, page_size=8, n_pages=13, max_seq_pages=12,
              reserve="optimistic", prefill_chunk=32)
    je = JEngine(jp, jcfg, **kw)
    te = TEngine(tp, tcfg, device="cpu", **kw)
    for p in _trace():
        assert je.submit(p, max_new=16) == te.submit(p, max_new=16)
    steps = 0
    while je.busy or te.busy:
        je.step()
        te.step()
        steps += 1
        assert _state(te) == _state(je), f"step {steps}"
        np.testing.assert_array_equal(te.kv.ptab, je.kv.ptab)
        np.testing.assert_array_equal(te.kv.lens, je.kv.lens)
        assert steps < 500
    assert je.stats()["evictions"] >= 1
    assert te.stats()["evictions"] == je.stats()["evictions"]
    jr, tr = je.results(), te.results()
    assert sorted(jr) == sorted(tr) == list(range(5))
    for rid in jr:
        assert tr[rid].tolist() == jr[rid].tolist(), rid


def test_conservative_admission_matches_reference(models):
    """Conservative reserve: head-of-line blocking on the page budget."""
    (jp, jcfg), (tp, tcfg) = models["fp"]
    kw = dict(n_slots=2, page_size=8, n_pages=12, max_seq_pages=10,
              reserve="conservative", prefill_chunk=16)
    je = JEngine(jp, jcfg, **kw)
    te = TEngine(tp, tcfg, device="cpu", **kw)
    for p in _trace()[:4]:
        je.submit(p, max_new=8)
        te.submit(p, max_new=8)
    while je.busy or te.busy:
        je.step()
        te.step()
        assert _state(te) == _state(je)
        np.testing.assert_array_equal(te.kv.ptab, je.kv.ptab)
    assert {k: v.tolist() for k, v in te.results().items()} == \
        {k: v.tolist() for k, v in je.results().items()}


def test_submit_rejects_oversize_and_stats(models):
    _, (tp, tcfg) = models["fp"]
    te = TEngine(tp, tcfg, device="cpu", n_slots=2, page_size=4, n_pages=9)
    with pytest.raises(ValueError, match="per-sequence limit"):
        te.submit(np.zeros(20, np.int32), max_new=4)
    for p in _trace()[1::2]:
        te.submit(p[:12], max_new=3)
    te.run()
    st = te.stats()
    assert st["rejects"] == 1 and st["finished"] == 2
    assert st["decode_tokens"] == 2 * 2        # first token from prefill
    # the port's one percentile (``obs.percentile``, the reference's
    # formula): numpy's linear method within its last bit
    lat = [r.t_finish - r.t_arrive for r in te.requests.values()]
    for q in (50, 99):
        assert st[f"latency_p{q}_s"] == percentile(lat, q)
        assert st[f"latency_p{q}_s"] == pytest.approx(
            float(np.percentile(lat, q)), rel=1e-12, abs=1e-12)
