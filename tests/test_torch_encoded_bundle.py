"""Port parity: calibrated encoded serving with searched encodings
(``repro_torch.serve.encoded``) against the JAX package, on reduced
qwen1.5-0.5b on the CPU: the calibration capture, the per-family row
weights, the bundle key and cache, the port's own search choosing the
reference's circuits, greedy tokens, and the CLI's default
``--encoding search``.

Tolerances: captured values are the f32 activations of two forwards that
sum in different orders (rtol 1e-5); row weights within 1e-6 (measured:
equal); searched RMSEs within rtol 1e-5 (``tests/test_torch_search.py``);
folded bf16 weights and tokens exactly."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.core.search import random_search as j_random_search  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import encoded as JE  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import encoded as TE  # noqa: E402

from test_torch_search import TIE_RTOL, _first_choice_apart  # noqa: E402

# the bundle's options: the reference CLI's search at a test's size
OPTS = dict(n_samples=16, refine=8, calib_batches=2, calib_batch_size=2,
            calib_seq=32)
FAMILIES = ("wg", "wi", "wk", "wo", "wq", "wv")

# A family whose search parts from the reference's at a near-tie (ROADMAP
# Queue C): family -> the anneal step where the choices part.  There the
# candidates' RMSEs are within TIE_RTOL of each other in both packages,
# below one f32 ulp of the RMSE, so the choice is rounding, not a fault.
NEAR_TIES = {"wi": 0}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    jcfg = jget("qwen1.5-0.5b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    ref_dir = str(tmp_path_factory.mktemp("ref"))
    jpe, jce, jinfo = JE.prepare_encoded_serving(jp, jcfg, cache_dir=ref_dir,
                                                 verbose=False, **OPTS)
    tcfg = tget("qwen1.5-0.5b").reduced()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    # the reference's capture, keyed by the port's sites
    st = JE.capture_activation_stats(
        jp, jcfg, n_batches=OPTS["calib_batches"],
        batch_size=OPTS["calib_batch_size"], seq_len=OPTS["calib_seq"])
    matched = JE._match_linears(jp, st)
    amax, samples = {}, {}
    for (path, name), m in matched.items():
        for li, h in enumerate(m["hashes"]):
            amax[(li, path[-1], name)] = st.amax[h]
            samples[(li, path[-1], name)] = st.samples[h]
    return dict(jcfg=jcfg, jp=jp, jpe=jpe, jce=jce, jinfo=jinfo,
                ref_dir=ref_dir, tcfg=tcfg, tp=tp,
                tokens=_serve(JEngine, jpe, jce),
                jrw=JE.family_row_weights(jp, matched, st, 8),
                stats=TE.CalibStats(amax, samples))


@pytest.fixture(scope="module")
def own(ref, tmp_path_factory):
    """The port's own build: its calibration, search and fold."""
    cache = str(tmp_path_factory.mktemp("own"))
    out = TE.prepare_encoded_serving(ref["tp"], ref["tcfg"], cache_dir=cache,
                                     verbose=False, device="cpu", **OPTS)
    return out, cache


def _trace():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (12, 30, 7)]


def _serve(engine_cls, params, cfg, **kw):
    eng = engine_cls(params, cfg, n_slots=2, page_size=8, n_pages=32,
                     prefill_chunk=16, **kw)
    rids = [eng.submit(p, max_new=6) for p in _trace()]
    outs = eng.run()
    return [list(map(int, outs[r])) for r in rids]


def _same_circuit(a, b):
    np.testing.assert_array_equal(a.gate_types, b.gate_types)
    np.testing.assert_array_equal(a.in_idx, b.in_idx)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

def test_capture_and_row_weights_match_reference(ref):
    want = ref["stats"]
    stats = TE.capture_activation_stats(
        ref["tp"], ref["tcfg"], n_batches=OPTS["calib_batches"],
        batch_size=OPTS["calib_batch_size"], seq_len=OPTS["calib_seq"])
    assert set(stats.samples) == set(want.samples)
    assert len(want.samples) == 7 * ref["tcfg"].n_layers
    for key, calls in want.samples.items():
        got = stats.samples[key]
        assert [len(c) for c in got] == [len(c) for c in calls], key
        a, b = np.concatenate(got), np.concatenate(calls)
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
        assert stats.amax[key] == pytest.approx(want.amax[key], rel=1e-6)
    # the port's row weights from the reference's own samples
    trw = TE.family_row_weights(ref["tp"], want, 8)
    assert sorted(trw) == sorted(ref["jrw"]) == list(FAMILIES)
    for name in FAMILIES:
        assert trw[name].dtype == np.float32
        np.testing.assert_allclose(trw[name], ref["jrw"][name], rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the bundle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("override", [False, True])
def test_bundle_key_matches_reference(ref, override):
    opts = dict(bits=8, m_bits=48, seed=0, blend=0.5, **OPTS)
    if override:
        circ, s = exact_product_circuit(8, 8)
        mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
        opts["override"] = JE._macs_fingerprint(
            {n: mac for n in TE.FAMILIES})
        assert opts["override"] == TE._macs_fingerprint(TE.exact_encodings())
    assert TE._bundle_key(ref["tcfg"], ref["tp"], opts) == \
        JE._bundle_key(ref["jcfg"], ref["jp"], opts)


def test_reference_bundle_is_a_cache_hit(ref):
    """Same key, the reference's encodings and folded leaves (its f32 fold
    rounded to bf16), and the reference Engine's greedy tokens."""
    pe, ce, info = TE.prepare_encoded_serving(
        ref["tp"], ref["tcfg"], cache_dir=ref["ref_dir"], verbose=False,
        device="cpu", **OPTS)
    assert info["loaded"] and info["bundle_dir"] == ref["jinfo"]["bundle_dir"]
    assert info["n_folded"] == 7 * ref["tcfg"].n_layers
    assert info["roles"] == ref["jinfo"]["roles"]
    for name, jm in ref["jce"].mac.macs.items():
        _same_circuit(ce.mac.macs[name].spec.circuit, jm.spec.circuit)
        np.testing.assert_array_equal(ce.mac.macs[name].spec.s, jm.spec.s)
    src = ref["jpe"]["stack"]["mlp"]["wi_fw"]
    want = np.asarray(jax.numpy.asarray(src).astype(jax.numpy.bfloat16),
                      np.float32)
    for i, layer in enumerate(pe["layers"]):
        assert layer["mlp"]["wi_fw"].dtype == torch.bfloat16
        np.testing.assert_array_equal(layer["mlp"]["wi_fw"].float().numpy(),
                                      want[i])
    assert _serve(TEngine, pe, ce, device="cpu") == ref["tokens"]


def test_own_build_picks_reference_circuits(ref, own):
    """The port's calibration and search choose the reference's circuit
    for every family, or part from it at a recorded near-tie; where none
    is recorded, its bundle serves the reference's greedy tokens."""
    (pe, ce, info), _ = own
    assert not info["loaded"]
    assert os.path.basename(info["bundle_dir"]) == \
        os.path.basename(ref["jinfo"]["bundle_dir"])
    jmacs = ref["jce"].mac.macs
    assert sorted(ce.mac.macs) == sorted(jmacs) == list(FAMILIES)
    rw = ref["jrw"]
    for i, name in enumerate(FAMILIES):
        tm, jm = ce.mac.macs[name].spec, jmacs[name].spec
        assert tm.rmse == pytest.approx(jm.rmse, rel=1e-5)
        if name not in NEAR_TIES:
            _same_circuit(tm.circuit, jm.circuit)
            continue
        # replay the family's anneal from the reference's random search
        # and check that the choices part at the recorded step, at a tie
        start = j_random_search(101 * i, 48, OPTS["n_samples"],
                                row_weights=rw[name],
                                patience=OPTS["n_samples"])
        step, spread_ref, spread_port = _first_choice_apart(
            start.spec, 101 * i + 7919, OPTS["refine"], 64, rw[name], 0.0)
        assert step == NEAR_TIES[name]
        assert spread_ref <= TIE_RTOL and spread_port <= TIE_RTOL
    # a circuit chosen at a near-tie gives another table (the same RMSE,
    # other entries), and the reduced model's random logits have small
    # margins: its tokens are compared only without a recorded tie
    tokens = _serve(TEngine, pe, ce, device="cpu")
    if not NEAR_TIES:
        assert tokens == ref["tokens"]
    with open(os.path.join(info["bundle_dir"], "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(ref["jinfo"]["bundle_dir"], "manifest.json")) as f:
        jmanifest = json.load(f)
    assert set(manifest) == set(jmanifest) | {"fw_dtype"}
    assert manifest["fw_dtype"] == "bfloat16"
    assert manifest["key"] == jmanifest["key"]
    assert manifest["opts"] == jmanifest["opts"]
    for name, fam in manifest["families"].items():
        assert fam["tp_role"] == jmanifest["families"][name]["tp_role"]
        assert fam["n_a_planes"] == ce.mac.macs[name].program.n_a_planes


def test_own_fold_of_the_reference_encodings_matches(ref, tmp_path):
    """The port's calibration and fold with the reference's searched
    encodings (1–3-bit monomials, U per family): the reference's folded
    bitplane weights bit for bit after bf16, its weight scales, its
    activation scales within 1e-6 and its biases within f32 rounding.

    The bias sums terms up to ~6x its size (fitted position weights reach
    ~1e4) in another f32 order than XLA: measured 0.094 apart on a bias of
    7.4e4, both within 0.06 of the f64 value.  Logits and tokens are not
    compared: with an approximate product table, one activation code that
    lands on the other side of a rounding boundary (the activation scales
    differ by up to 2.2e-7) moves a linear's output by a table error, not
    by one product step, and the reduced model's logits then part by up to
    0.46 (ROADMAP Queue C).  The reference's own bundle serves its tokens
    exactly (``test_reference_bundle_is_a_cache_hit``)."""
    macs = {}
    for name, jm in ref["jce"].mac.macs.items():
        EncodedMac.save(jm.spec, f"enc_{name}", artifact_dir=str(tmp_path))
        macs[name] = TE.EncodedMac.load(f"enc_{name}",
                                        artifact_dir=str(tmp_path))
    assert len({m.program.n_a_planes for m in macs.values()}) > 1
    pe, ce, info = TE.prepare_encoded_serving(
        ref["tp"], ref["tcfg"], cache_dir=str(tmp_path), verbose=False,
        device="cpu", macs_override=macs, **OPTS)
    assert not info["loaded"]
    for sub, leaves in ref["jpe"]["stack"].items():
        if not isinstance(leaves, dict):
            continue
        for k, v in leaves.items():
            if not k.endswith(("_fw", "_fb", "_as", "_ws")):
                continue
            got = np.stack([layer[sub][k].float().numpy()
                            for layer in pe["layers"]])
            if k.endswith("_fw"):
                want = np.asarray(jax.numpy.asarray(v).astype(
                    jax.numpy.bfloat16), np.float32)
                np.testing.assert_array_equal(got, want, k)
            elif k.endswith("_fb"):
                want = np.asarray(v)
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=1e-5 * np.abs(want).max())
            elif k.endswith("_ws"):
                np.testing.assert_array_equal(got, np.asarray(v))
            else:
                np.testing.assert_allclose(got, np.asarray(v), rtol=1e-6)


def test_second_call_loads_the_same_params(ref, own):
    (pe, ce, _), cache = own
    pe2, ce2, info = TE.prepare_encoded_serving(
        ref["tp"], ref["tcfg"], cache_dir=cache, verbose=False,
        device="cpu", **OPTS)
    assert info["loaded"]
    for a, b in zip(pe["layers"], pe2["layers"]):
        for sub in ("attn", "mlp"):
            assert set(a[sub]) == set(b[sub])
            for k in a[sub]:
                assert a[sub][k].dtype == b[sub][k].dtype
                assert torch.equal(a[sub][k], b[sub][k]), (sub, k)
    for name, m in ce.mac.macs.items():
        _same_circuit(ce2.mac.macs[name].spec.circuit, m.spec.circuit)


def test_force_and_a_missing_or_torn_bundle_rebuild(ref, tmp_path):
    """The exact-encoding override goes through the same cache: a second
    call loads; ``force`` rebuilds; a bundle without its manifest, or with
    a torn ``folded.npz``, is rebuilt."""
    kw = dict(cache_dir=str(tmp_path), macs_override=TE.exact_encodings(),
              verbose=False, device="cpu", calib_batches=1)

    def prep(**extra):
        return TE.prepare_encoded_serving(ref["tp"], ref["tcfg"], **kw,
                                          **extra)[2]

    first = prep()
    bundle = first["bundle_dir"]
    assert not first["loaded"] and prep()["loaded"]
    assert not prep(force=True)["loaded"]
    os.remove(os.path.join(bundle, "manifest.json"))
    assert not prep()["loaded"]
    assert os.path.exists(os.path.join(bundle, "manifest.json"))
    with open(os.path.join(bundle, "folded.npz"), "r+b") as f:
        f.truncate(100)
    assert not prep()["loaded"]
    assert prep()["loaded"]
    assert sorted(os.listdir(bundle)) == sorted(
        ["manifest.json", "folded.npz"]
        + [f"enc_{n}.json" for n in TE.FAMILIES])


def test_cli_searches_then_hits_the_cache(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(TE, "DEFAULT_CACHE_DIR", str(tmp_path))
    argv = ["--reduced", "--continuous", "--mac", "encoded", "--device",
            "cpu", "--calib-samples", "4", "--calib-refine", "4",
            "--calib-batches", "1", "--requests", "2", "--max-new", "3"]
    tcli.main(argv)
    first = capsys.readouterr().out
    assert "searched+folded" in first and "served 2 requests" in first
    tcli.main(argv)
    second = capsys.readouterr().out
    assert "cache hit" in second
    # the same tokens from the cached bundle
    toks = [ln for ln in first.splitlines() if ln.startswith("req")]
    assert toks and toks == [ln for ln in second.splitlines()
                             if ln.startswith("req")]
