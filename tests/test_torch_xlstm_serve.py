"""Port parity for xlstm-1.3b's encoded serving on the CPU (reduced, one
mLSTM and one sLSTM block: ``slstm_every=2``) against the JAX package,
with the exact encoding: ``apply_model`` logits (within 1e-4 of the
largest |logit|), a prefill then decode steps over the dense cache
(logits and states), greedy tokens of ``generate`` and ``ServeEngine``
(identical), the folded families, and a bundle the reference built being
a cache hit.  The modules are held in ``tests/test_torch_xlstm.py``, the
model in fp in ``tests/test_torch_xlstm_model.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import init_cache as j_cache  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.nn.common import set_activation_recorder  # noqa: E402
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa: E402
from repro.serve.engine import ServeEngine as JServe  # noqa: E402
from repro.serve.engine import generate as j_generate  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import (apply_model, init_cache,  # noqa: E402
                                layer_kinds, params_from_jax)
from repro_torch.nn.common import activation_recorder  # noqa: E402
from repro_torch.serve import (ServeEngine as TServe,  # noqa: E402
                               arch_families, exact_encodings, generate,
                               prepare_encoded_serving)

ARCH = "xlstm-1.3b"
REC_TOL = dict(rtol=2e-4, atol=2e-4)
# a short calibration in both packages (the bundle key holds it)
CALIB = dict(calib_batches=1, calib_batch_size=2, calib_seq=32)
# where logits part, the first int8 code apart must sit this close to a
# .5 rounding boundary (x / scale units): f32 order moved it there
ORIGIN_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _close(got, want, share=1e-4, err_msg=""):
    """Every element within ``share`` of the reference's largest |value|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= share * top, f"{err_msg}: {err} > {share} x {top}"


def _tokens(S, B=2, seed=5):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


def _cfgs():
    """Reduced xlstm with one mLSTM and one sLSTM block (``reduced()``
    alone keeps 2 // 8 = 0 sLSTM blocks)."""
    return (dataclasses.replace(jget(ARCH).reduced(), slstm_every=2),
            dataclasses.replace(tget(ARCH).reduced(), slstm_every=2))


def _j_init(jcfg):
    # jitted: a fraction of the eager init's compile time
    return jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


def _trace():
    rng = np.random.default_rng(6)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (70, 17, 40)]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The reference's params exact-encoded with its own bundle (and its
    static serve of the trace), and the port's: the fp params bridged,
    the encoded ones both bridged and folded by the port."""
    jcfg, tcfg = _cfgs()
    jp = _j_init(jcfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    ref_dir = str(tmp_path_factory.mktemp("ref"))
    jpe, jce, jinfo = j_prepare(
        jp, jcfg, macs_override={n: mac for n in arch_families(tcfg)},
        cache_dir=ref_dir, verbose=False, **CALIB)
    tp = params_from_jax(_to_np(jp), tcfg, "cpu")
    tpe, tce, tinfo = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(families=arch_families(tcfg)),
        device="cpu", cache_dir=str(tmp_path_factory.mktemp("own")),
        verbose=False, **CALIB)
    return {"ref_dir": ref_dir, "jinfo": jinfo, "tinfo": tinfo, "tp": tp,
            "ref": (jpe, jce), "own": (tpe, tce),
            "bridged": params_from_jax(_to_np(jpe), tcfg, "cpu"),
            "static": JServe(jpe, jce, batch_slots=3).run(_trace(),
                                                          max_new=6)}


def _codes_in_order(jp, jcfg, tp, tcfg, toks):
    """Every folded linear's input over its activation scale, in call
    order, in both packages (the reference unrolled and without remat, as
    its calibration runs: concrete values, the same order at this depth);
    every linear of this arch is folded."""
    scales = {}

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k + "_fw" in node:
                scales[id(v)] = float(node[k + "_as"])
    walk({k: v for k, v in tp.items() if k != "layers"})
    for layer in tp["layers"]:
        walk(layer)
    port, ref, sas = [], [], []

    def hook(name, w, x):
        sas.append(scales[id(w)])
        port.append(x.float().numpy() / sas[-1])
    with torch.inference_mode(), activation_recorder(hook):
        apply_model(tp, tcfg, torch.from_numpy(toks))
    prev = set_activation_recorder(
        lambda name, w, x: ref.append(np.asarray(x, np.float32)))
    try:
        j_apply(jp, dataclasses.replace(jcfg, scan_layers=False,
                                        remat=False), jnp.asarray(toks))
    finally:
        set_activation_recorder(prev)
    assert len(ref) == len(port)
    return [(r / sa, t) for r, t, sa in zip(ref, port, sas)]


def _logits(jp, jcfg, tp, tcfg):
    """Within 1e-4 of the largest |logit|; or, where an int8 activation
    code parts between the packages (one code step moves a linear's
    output, so the logits after it part by far more), the first code
    apart sits within ``ORIGIN_TOL`` of a .5 boundary on both sides."""
    assert layer_kinds(tcfg) == ["mlstm", "slstm"]
    toks = _tokens(70)
    jl, _, _ = j_apply(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = apply_model(tp, tcfg, torch.from_numpy(toks))
    err = float(np.abs(tl.numpy() - np.asarray(jl)).max())
    if err <= 1e-4 * float(np.abs(np.asarray(jl)).max()):
        return
    for r, t in _codes_in_order(jp, jcfg, tp, tcfg, toks):
        qr, qt = (np.clip(np.round(a), -127, 127) for a in (r, t))
        apart = np.argwhere(qr != qt)
        if len(apart):
            idx = tuple(apart[0])
            edge = max(abs(a[idx] - np.floor(a[idx]) - 0.5) for a in (r, t))
            assert edge <= ORIGIN_TOL, (idx, r[idx], t[idx])
            return
        np.testing.assert_allclose(t, r, rtol=0, atol=ORIGIN_TOL)
    raise AssertionError(f"logits part by {err} with every int8 code "
                         "equal")


def _prefill_then_decode(jp, jcfg, tp, tcfg):
    """A 40-token prefill into the dense cache (both states from their
    fresh values), then 3 decode steps fed the reference's greedy tokens:
    every step's logits, and the states after them."""
    jc = j_cache(jcfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    feed = jnp.asarray(_tokens(40))
    for i in range(4):
        jl, jc, _ = j_apply(jp, jcfg, feed, cache=jc)
        with torch.inference_mode():
            tl, tc = apply_model(tp, tcfg, torch.from_numpy(np.array(feed)),
                                 cache=tc)
        _close(tl.numpy(), jl, err_msg=f"step {i}")
        assert int(tc["pos"]) == int(jc["pos"])
        feed = jnp.argmax(jl[:, -1:, :tcfg.vocab_size], -1).astype(
            jnp.int32)
    ref = jc["layers"]["xlstm"]
    for sub, idx in (("mlstm", 0), ("slstm", 1)):
        for k, t in tc["layers"][idx][sub].items():
            np.testing.assert_allclose(t.numpy(), np.asarray(ref[sub][k][0]),
                                       err_msg=f"{sub} {k}", **REC_TOL)


def _generate_and_static(jp, jcfg, tp, tcfg, want_static):
    """``generate`` over a uniform batch and ``ServeEngine`` over a ragged
    trace in one chunk (left-padded; the pads enter the recurrent states
    unmasked, as in the reference): greedy tokens identical."""
    toks = _tokens(30, B=3)
    want = np.asarray(j_generate(jp, jcfg, jnp.asarray(toks), max_new=6))
    np.testing.assert_array_equal(generate(tp, tcfg, toks, max_new=6)
                                  .numpy(), want)
    eng = TServe(tp, tcfg, batch_slots=3, device="cpu")
    for i, (g, w) in enumerate(zip(eng.run(_trace(), max_new=6),
                                   want_static)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")
    assert eng.stats()["decode_steps"] == 5


def test_logits_match_reference(model):
    (jpe, jce), (_, tce) = model["ref"], model["own"]
    _logits(jpe, jce, model["bridged"], tce)


def test_prefill_then_decode_matches_reference(model):
    (jpe, jce), (_, tce) = model["ref"], model["own"]
    _prefill_then_decode(jpe, jce, model["bridged"], tce)


def test_generate_and_static_engine_match_reference(model):
    """With the port's own calibration and fold."""
    (jpe, jce), (tpe, tce) = model["ref"], model["own"]
    _generate_and_static(jpe, jce, tpe, tce, model["static"])


def test_own_fold_covers_the_families(model):
    """The mLSTM's wi and wo, the sLSTM's wi, wup and wo and the untied
    head fold; the conv, q/k/v blocks, gate projections and the
    recurrence stay fp, as the reference's calibration leaves them."""
    info = model["tinfo"]
    pe = model["own"][0]
    assert info["n_folded"] == 2 + 3 + 1
    assert {k for k in pe["layers"][0]["mlstm"] if k.endswith("_fw")} == \
        {"wi_fw", "wo_fw"}
    assert {k for k in pe["layers"][1]["slstm"] if k.endswith("_fw")} == \
        {"wi_fw", "wup_fw", "wo_fw"}
    assert "w_fw" in pe["lm_head"]
    assert set(info["families"]) == {"wi", "wo", "wup", "w"}
    assert model["jinfo"]["n_folded"] == info["n_folded"]


def test_reference_bundle_is_a_cache_hit(model):
    """The bundle the reference built loads in the port under the same
    key, with its folded leaves (as bf16) and its greedy tokens."""
    tcfg = _cfgs()[1]
    pe, ce, info = prepare_encoded_serving(
        model["tp"], tcfg,
        macs_override=exact_encodings(families=arch_families(tcfg)),
        cache_dir=model["ref_dir"], device="cpu", verbose=False, **CALIB)
    assert info["loaded"]
    assert info["bundle_dir"] == model["jinfo"]["bundle_dir"]
    jpe = model["ref"][0]
    src = np.asarray(jnp.asarray(jpe["xlstm"]["slstm"]["slstm"]["wup_fw"])
                     .astype(jnp.bfloat16), np.float32)
    got = pe["layers"][1]["slstm"]["wup_fw"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), src[0])
    got = TServe(pe, ce, batch_slots=3, device="cpu").run(_trace(),
                                                         max_new=6)
    for i, (g, w) in enumerate(zip(got, model["static"])):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")
