"""Port parity for the serving telemetry (``repro_torch.obs``,
``repro_torch.serve.telemetry``, the engine's and scheduler's wiring and
the CLI's flags) against the JAX package's: percentiles, registry
snapshots and tracer exports from the same operations; the continuous
``Engine`` traced and timed, plain, with the prefix cache and a
copy-on-write, under eviction and stalls, and with speculative decoding,
against the reference ``Engine`` on the same trace (tokens, counters,
gauges, histogram counts, the trace's skeleton per track, phase
reconciliation, ``stats()`` keys); the drift monitor against the
reference's; the profiler hook; the CLI (reduced qwen1.5-0.5b, CPU)."""
import collections
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa
from repro.serve.telemetry import ServeTelemetry as JTel  # noqa: E402

from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.obs.profile import TRACE_FILE  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import exact_encodings, prepare_encoded_serving  # noqa
from repro_torch.serve.scheduler import (DECODING, FINISHED,  # noqa: E402
                                         Request)
from repro_torch.serve.telemetry import (TID_DEVICE, TID_ENGINE,  # noqa
                                         ServeTelemetry, req_tid)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the drift monitor's |Δlogit| between the packages (f32 sums in other
# orders); its top-1 agreement must be equal
DELTA_RTOL = 1e-5


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """fp and encoded-exact params of reduced qwen1.5-0.5b in both
    packages; the port loads the reference's bundle (a cache hit), so
    both serve the same folded weights."""
    jcfg = jget("qwen1.5-0.5b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    override = {n: mac for n in ("wq", "wk", "wv", "wo", "wi", "wg", "w")}
    cache = str(tmp_path_factory.mktemp("bundle"))
    jpe, jce, _ = j_prepare(jp, jcfg, macs_override=override,
                            cache_dir=cache, verbose=False)
    tcfg = tget("qwen1.5-0.5b").reduced()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    tpe, tce, info = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(), device="cpu",
        cache_dir=cache, verbose=False)
    assert info["loaded"]
    return {"fp": ((jp, jcfg), (tp, tcfg)),
            "encoded": ((jpe, jce), (tpe, tce))}


# ---------------------------------------------------------------------------
# percentile, registry, tracer: the same operations, the same results
# ---------------------------------------------------------------------------

QS = (0, 0.5, 1, 5, 25, 33.3, 50, 66.7, 90, 95, 99, 99.9, 100)


@pytest.mark.parametrize("sizes", [range(0, 6), range(6, 20),
                                   range(20, 51, 3)])
def test_percentile_matches_reference_and_numpy(sizes):
    """Bit for bit the reference's percentile; numpy's linear method
    within its last bit (numpy interpolates from the nearer rank), as the
    reference's own test holds it."""
    rng = np.random.default_rng(len(sizes))
    for n in sizes:
        xs = rng.normal(size=n).tolist()
        for q in QS:
            got = tobs.percentile(xs, q)
            want = jobs.percentile(xs, q)
            if n == 0:
                assert np.isnan(got) and np.isnan(want)
                continue
            assert got == want, (n, q)
            assert got == pytest.approx(float(np.percentile(xs, q)),
                                        rel=1e-12, abs=1e-12)
        assert tobs.percentiles(xs, QS) == jobs.percentiles(xs, QS) or n == 0
    for q in (-1, 100.5):
        with pytest.raises(ValueError):
            tobs.percentile([1.0], q)


def _registry_ops(reg, seed):
    """A seeded sequence of counter, gauge and histogram operations with
    labels (and the errors the registry must raise)."""
    rng = np.random.default_rng(seed)
    labels = [{}, {"mac": "fp"}, {"mac": "encoded_infer"},
              {"fn": "decode", "mac": "fp"}]
    for i in range(200):
        kind = rng.integers(0, 3)
        lab = labels[rng.integers(0, len(labels))]
        name = f"m{rng.integers(0, 4)}_{'cgh'[kind]}"
        if kind == 0:
            reg.counter(name, "a counter").inc(float(rng.integers(0, 5)),
                                               **lab)
        elif kind == 1:
            g = reg.gauge(name, "a gauge")
            if rng.random() < 0.5:
                g.set(float(rng.normal()), **lab)
            else:
                g.inc(float(rng.normal()), **lab)
        else:
            reg.histogram(name, "a histogram",
                          buckets=(0.5, 1, 2.5, 10)).observe(
                float(rng.exponential(3.0)), **lab)
    with pytest.raises(TypeError):
        reg.gauge("m0_c")
    with pytest.raises(ValueError):
        reg.counter("m0_c").inc(-1)
    return reg


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_snapshot_matches_reference(seed, tmp_path):
    ref = _registry_ops(jobs.MetricsRegistry(), seed)
    got = _registry_ops(tobs.MetricsRegistry(), seed)
    assert json.dumps(got.snapshot(), default=float) == \
        json.dumps(ref.snapshot(), default=float)
    assert got.names() == ref.names()
    for name in ref.names():
        if isinstance(ref.get(name), jobs.Histogram):
            for lab in ({}, {"mac": "fp"}):
                assert got.get(name).percentile(50, **lab) == \
                    ref.get(name).percentile(50, **lab) or \
                    got.get(name).count(**lab) == 0
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    ref.write_json(str(a))
    got.write_json(str(b))
    assert a.read_text() == b.read_text()


def _tracer_ops(tr):
    """Spans and instants at explicit times on the engine, device and two
    request tracks."""
    tr.t0 = 100.0
    tr.thread(0, "engine")
    tr.thread(1, "device")
    tr.thread(17, "req 1")
    tr.thread(17, "not renamed")
    for i in range(5):
        t = 100.0 + i * 0.01
        tr.complete("step", t, t + 0.004, tid=0, cat="engine",
                    args={"step": i + 1})
        tr.complete("device:decode", t + 0.001, t + 0.003, tid=1,
                    cat="device", args={"n_active": i})
        tr.instant("stall", tid=17, cat="lifecycle", args={"rid": 1},
                   t_s=t + 0.002)
    tr.complete("clamped", 100.2, 100.1, tid=16)      # negative → dur 0
    tr.instant("reject", tid=0, args={"plen": 40, "limit": 32}, t_s=100.3)
    return tr


def test_tracer_export_matches_reference(tmp_path):
    ref, got = _tracer_ops(jobs.Tracer()), _tracer_ops(tobs.Tracer())
    assert got.chrome_events() == ref.chrome_events()
    for kind in ("chrome", "jsonl"):
        a, b = tmp_path / f"a.{kind}", tmp_path / f"b.{kind}"
        getattr(ref, f"write_{kind}")(str(a))
        getattr(got, f"write_{kind}")(str(b))
        assert a.read_text() == b.read_text()
    with got.span("outer", tid=0, args={"k": 1}):
        pass
    assert got.events[-1]["name"] == "outer" and got.events[-1]["dur"] >= 0


def test_disabled_tracer_is_free():
    tr = tobs.Tracer(enabled=False)
    s1, s2 = tr.span("a", tid=3), tr.span("b", args={"x": 1})
    assert s1 is tobs.NULL_SPAN and s2 is tobs.NULL_SPAN
    with s1:
        pass
    tr.thread(0, "engine")
    tr.complete("c", 0.0, 1.0)
    tr.instant("d")
    assert tr.events == [] and tr.chrome_events() == []
    tel = ServeTelemetry.disabled()
    assert not tel.tracer.enabled and tel.drift is None
    assert not tel.time_device and tel.profile_dir is None
    tel.write()                                  # all-None export: no-op
    tel = ServeTelemetry(trace=True)
    assert {e["tid"] for e in tel.tracer.chrome_events()} == \
        {TID_ENGINE, TID_DEVICE}
    assert req_tid(0) > TID_DEVICE


# ---------------------------------------------------------------------------
# the engine, traced and timed, against the reference's
# ---------------------------------------------------------------------------

def _prompts(vocab, lens, seed=0, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, shared).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, n)
                            .astype(np.int32)]) for n in lens]


# name → (params, engine kwargs, prompt lens, max_new, shared prefix,
# drift every N steps or None, force a copy-on-write)
CASES = {
    "plain": ("encoded", dict(n_slots=3, page_size=8, n_pages=40,
                              prefill_chunk=16), (20, 9, 33, 5), 8, 0, 4,
              False),
    "prefix_cow": ("fp", dict(n_slots=2, page_size=4, n_pages=24,
                              prefill_chunk=8, prefix_cache=True),
                   (3, 6, 2, 5), 6, 13, None, True),
    "evict_stall": ("fp", dict(n_slots=2, page_size=4, n_pages=6,
                               reserve="optimistic", prefill_chunk=4),
                    (5, 3, 6), 10, 0, None, False),
    "spec": ("encoded", dict(n_slots=3, page_size=8, n_pages=40,
                             prefill_chunk=16, spec_decode=4),
             (20, 9, 33, 5), 8, 0, 1, False),
}


def _lockstep(engines, prompts, max_new, force_cow, ps):
    """Submit the trace to every engine and step them together; with
    ``force_cow``, once request 1 decodes inside a page, a peer takes a
    reference to that page (both engines alike), so its next write must
    copy it; the peer lets go at the end.  Returns the drift monitors'
    (agreement, |Δlogit|) after each step."""
    for p in prompts:
        assert len({e.submit(p, max_new=max_new) for e in engines}) == 1
    shared, drift, steps = None, [], 0
    while any(e.busy for e in engines):
        for e in engines:
            e.step()
        steps += 1
        assert steps < 400
        drift.append([(e.tel.drift.last, e.tel.drift.last_delta)
                      if e.tel.drift is not None else None
                      for e in engines])
        r = engines[0].requests[1]
        if force_cow and shared is None and r.state == DECODING \
                and r.n_cached % ps:
            shared = r.pages[r.n_cached // ps]
            for e in engines:
                assert e.requests[1].pages[r.n_cached // ps] == shared
                e.kv.alloc.retain(shared)
    if shared is not None:
        for e in engines:
            e.kv.alloc.free([shared])
    return drift


def _skeleton(events):
    """Per track: each event's (name, ph, cat, args), in order."""
    out = collections.defaultdict(list)
    for e in events:
        out[e["tid"]].append((e["name"], e["ph"], e.get("cat"),
                              json.dumps(e.get("args"), sort_keys=True)))
    return dict(out)


def _check_reconciled(eng, events):
    """Every finished request's queued + prefill + decode spans sum to its
    request span within 1 µs, and the request span is its latency."""
    spans = [e for e in events if e["ph"] == "X"]
    for rid, r in eng.requests.items():
        assert r.state == FINISHED
        mine = {e["name"]: e for e in spans if e["tid"] == req_tid(rid)}
        total = sum(mine[n]["dur"] for n in ("queued", "prefill", "decode"))
        assert abs(total - mine["request"]["dur"]) <= 1.0
        assert mine["request"]["dur"] == pytest.approx(
            (r.t_finish - r.t_arrive) * 1e6, abs=1.0)


def _registry(tel):
    snap = tel.registry.snapshot()
    # jit_compiles counts XLA compiles in the reference (memoized per
    # process) and CUDA-graph captures in the port (none on the CPU)
    counters = {n: v["series"] for n, v in snap["counters"].items()
                if n != "jit_compiles"}
    gauges = {n: v["series"] for n, v in snap["gauges"].items()}
    hists = {n: {k: s["count"] for k, s in v["series"].items()}
             for n, v in snap["histograms"].items()}
    return counters, gauges, hists


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_telemetry_matches_reference(models, case):
    mode, kw, lens, max_new, shared, every, force_cow = CASES[case]
    (jp, jcfg), (tp, tcfg) = models[mode]
    (jfp, jfc), (tfp, tfc) = models["fp"]
    jdrift = tdrift = None
    if every:
        jdrift = jobs.DriftMonitor(jfp, jfc, every=every, max_prompts=1)
        tdrift = tobs.DriftMonitor(tfp, tfc, every=every, max_prompts=1)
    jtel = JTel(trace=True, time_device=True, drift=jdrift)
    ttel = ServeTelemetry(trace=True, time_device=True, drift=tdrift)
    je = JEngine(jp, jcfg, telemetry=jtel, sanitize=True, **kw)
    te = TEngine(tp, tcfg, telemetry=ttel, sanitize=True, device="cpu",
                 **kw)
    prompts = _prompts(tcfg.vocab_size, lens, shared=shared)
    drift = _lockstep([je, te], prompts, max_new, force_cow,
                      kw["page_size"])
    # tokens
    jr, tr = je.results(), te.results()
    assert sorted(tr) == sorted(jr) == list(range(len(prompts)))
    assert all(tr[r].tolist() == jr[r].tolist() for r in jr)
    # counters and gauges exactly, histograms by count
    (jc, jg, jh), (tc, tg, th) = _registry(jtel), _registry(ttel)
    assert tc == jc
    assert th == jh
    a, b = (g.pop("encoded_drift_abs_logit", {}) for g in (tg, jg))
    assert a.keys() == b.keys()
    assert all(a[k] == pytest.approx(b[k], rel=DELTA_RTOL) for k in a)
    assert tg == jg
    # the drift gauges at the same steps
    for (ja, ta) in drift:
        if ja is None:
            continue
        assert ta[0] == ja[0]
        assert (ta[1] is None) == (ja[1] is None)
        if ta[1] is not None:
            assert ta[1] == pytest.approx(ja[1], rel=DELTA_RTOL)
    # the trace: structure per track, reconciliation
    jev, tev = jtel.tracer.chrome_events(), ttel.tracer.chrome_events()
    assert _skeleton(tev) == _skeleton(jev)
    _check_reconciled(je, jev)
    _check_reconciled(te, tev)
    # stats: the reference's keys and values that are no times
    js, ts = je.stats(), te.stats()
    assert set(js) <= set(ts)
    for k, v in js.items():
        if k.endswith(("_s", "_ms", "_ms_p50", "_ms_p99")) or \
                k in ("jit_compiles", "kv_pool_bytes"):
            continue
        assert ts[k] == v, k
    assert ts["admissions"] == tc["admissions"][""]
    assert ts["jit_compiles"] == 0 and ts["jit_compiles_by_step"] == {
        n: 0 for n in te.steps}
    assert te.kv.ledger.ops > 0 and te.kv.ledger.checks > 0
    counts = {"evict_stall": ("evictions", "stalls"),
              "prefix_cow": ("cow_copies", "prefix_hit_tokens"),
              "spec": ("spec_rounds",), "plain": ("prefills",)}[case]
    assert all(ts[k] > 0 for k in counts)
    assert len(te.step_ms) == ts["steps"]
    n_dev = sum(1 for e in tev if e["name"] == "device:decode")
    assert n_dev == ts["decode_steps"] == \
        sum(1 for e in tev if e["name"] == "decode_step")
    if every:
        assert ts["encoded_drift_top1"] == js["encoded_drift_top1"]
        assert 0.0 <= ts["encoded_drift_top1"] <= 1.0
    if case == "spec":
        assert ts["encoded_drift_top1"] == \
            ts["spec_accepted_tokens"] / ts["spec_draft_tokens"]


def test_telemetry_does_not_change_tokens(models):
    """Tracing and ``time_device`` change no token and add no capture."""
    _, (tp, tcfg) = models["encoded"]
    prompts = _prompts(tcfg.vocab_size, (5, 3, 6))
    outs = []
    for tel in (None, ServeTelemetry(trace=True, time_device=True)):
        eng = TEngine(tp, tcfg, n_slots=2, page_size=4, n_pages=6,
                      reserve="optimistic", prefill_chunk=4, device="cpu",
                      telemetry=tel)
        rids = [eng.submit(p, max_new=10) for p in prompts]
        res = eng.run()
        outs.append([res[r].tolist() for r in rids])
        assert eng.stats()["evictions"] >= 1
    assert outs[0] == outs[1]


def test_stats_ttft_includes_inflight_and_tpot(models):
    """TTFT covers requests with a first token that have not finished;
    TPOT is (t_finish - t_first) / (n_out - 1): the reference's values on
    the same requests."""
    sts = []
    for (p, c), eng_cls, kw in zip(models["fp"], (JEngine, TEngine),
                                   ({}, {"device": "cpu"})):
        eng = eng_cls(p, c, n_slots=2, page_size=4, n_pages=32, **kw)
        done = Request(rid=0, prompt=np.zeros(4, np.int32), max_new=4)
        done.state, done.out = FINISHED, [1, 2, 3, 4]
        done.t_arrive, done.t_first, done.t_finish = 100.0, 101.0, 104.0
        flight = Request(rid=1, prompt=np.zeros(4, np.int32), max_new=4)
        flight.state, flight.out = DECODING, [1]
        flight.t_arrive, flight.t_first = 100.0, 109.0
        eng.requests = {0: done, 1: flight}
        sts.append(eng.stats())
    js, ts = sts
    for k in ("latency_p50_s", "latency_p99_s", "ttft_p50_s", "ttft_p99_s",
              "tpot_p50_s", "tpot_p99_s"):
        assert ts[k] == js[k], k
    assert ts["ttft_p99_s"] == pytest.approx(9.0 - 0.08)
    assert np.isnan(ts["step_ms_p50"]) and np.isnan(js["step_ms_p50"])


# ---------------------------------------------------------------------------
# drift monitor
# ---------------------------------------------------------------------------

def test_logit_agreement_matches_reference(models):
    (jfp, jfc), (tfp, tfc) = models["fp"]
    (jpe, jce), (tpe, tce) = models["encoded"]
    prompts = _prompts(tfc.vocab_size, (6, 40), seed=3)
    want = jobs.logit_agreement(jfp, jfc, jpe, jce, prompts, max_len=32)
    got = tobs.logit_agreement(tfp, tfc, tpe, tce, prompts, max_len=32)
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1], rel=DELTA_RTOL)
    assert 0.0 < got[0] <= 1.0 and got[1] > 0
    same = tobs.logit_agreement(tfp, tfc, tfp, tfc, prompts)
    assert same == (1.0, 0.0)
    assert all(np.isnan(tobs.logit_agreement(tfp, tfc, tpe, tce, [[]])))
    reg = tobs.MetricsRegistry()
    mon = tobs.DriftMonitor(tfp, tfc, every=4).bind(reg)
    assert mon.maybe_sample(3, tpe, tce, prompts) is None
    assert mon.maybe_sample(4, tpe, tce, prompts) == \
        tobs.logit_agreement(tfp, tfc, tpe, tce, prompts[:2], max_len=32)[0]
    assert reg.counter("drift_samples").total() == 1
    assert mon.sample(tpe, tce, [np.zeros(0, np.int32)]) is None
    mon.observe_agreement(3, 4)
    mon.observe_agreement(0, 0)
    mon.observe_agreement(1, 4)
    assert mon.last == 0.5 == reg.gauge("encoded_drift_top1").value()
    with pytest.raises(ValueError):
        tobs.DriftMonitor(tfp, tfc, every=0)


# ---------------------------------------------------------------------------
# profiler, CLI, metric names
# ---------------------------------------------------------------------------

def test_profiler_trace(tmp_path):
    with tobs.profiler_trace(None) as on:
        assert on is False
    with tobs.profiler_trace("") as on:
        assert on is False
    d = tmp_path / "prof"
    with tobs.profiler_trace(str(d)) as on:
        assert on is True
        torch.ones(8).sum()
    doc = json.loads((d / TRACE_FILE).read_text())
    assert doc["traceEvents"]


@pytest.mark.parametrize("ext", ["json", "jsonl"])
def test_cli_writes_trace_and_metrics(tmp_path, capsys, ext):
    t, m = tmp_path / f"t.{ext}", tmp_path / "m.json"
    tcli.main(["--reduced", "--continuous", "--device", "cpu",
               "--trace-out", str(t),
               "--metrics-out", str(m), "--time-device", "--drift-every",
               "4", "--sanitize"])
    out = capsys.readouterr().out
    assert re.search(r"^  device: decode_p50=[0-9.]+ms prefill_p50=[0-9.]+ms$",
                     out, re.M)
    assert re.search(r"^  drift: top1_agreement=1\.0000 "
                     r"abs_logit_delta=0\.0000$", out, re.M)
    assert f"  wrote {t}\n" in out and f"  wrote {m}\n" in out
    snap = json.loads(m.read_text())
    assert snap["counters"]["drift_samples"]["series"][""] >= 1
    if ext == "json":
        events = json.loads(t.read_text())["traceEvents"]
    else:
        events = [json.loads(x) for x in t.read_text().splitlines()]
    names = {e["name"] for e in events}
    assert {"step", "decode_step", "device:decode", "device:prefill",
            "submit", "admit", "first_token", "request", "queued",
            "prefill", "decode"} <= names


def _doc_metric_names():
    """Every metric name in the table of docs/observability.md."""
    with open(os.path.join(ROOT, "docs", "observability.md")) as f:
        text = f.read()
    table = text[text.index("The engine registers"):
                 text.index("`registry.snapshot()`")]
    names = set()
    for line in table.splitlines():
        if line.startswith("| `"):
            names |= set(re.findall(r"`([a-z_0-9]+)`", line.split("|")[1]))
    return names


def test_registered_metrics_are_the_documented(models):
    """Every metric the port's engine registers is in the observability
    doc's table, and a serve with every feature on registers all of
    them."""
    (tfp, tfc), (tp, tcfg) = models["fp"][1], models["encoded"][1]
    tel = ServeTelemetry(trace=True, time_device=True,
                         drift=tobs.DriftMonitor(tfp, tfc, every=2))
    eng = TEngine(tp, tcfg, n_slots=2, page_size=4, n_pages=24,
                  prefill_chunk=8, prefix_cache=True, spec_decode=2,
                  sanitize=True, telemetry=tel, device="cpu")
    for p in _prompts(tcfg.vocab_size, (3, 9), shared=8):
        eng.submit(p, max_new=4)
    eng.run()
    eng.stats()
    assert set(tel.registry.names()) == _doc_metric_names()
    plain = TEngine(tp, tcfg, device="cpu")
    assert set(plain.tel.registry.names()) <= _doc_metric_names()
