"""Port parity for serving the moe family on the CPU, reduced: the
configs field for field, ``apply_model`` logits (rtol = atol = 1e-4),
qwen3-moe-235b-a22b on the continuous ``Engine`` (its scheduler state,
page tables and lens after every step, and its tokens, against the JAX
``Engine`` with dense, int8 and int4 pools, fp and encoded-exact), both
archs on the static ``ServeEngine`` (tokens against the JAX
``ServeEngine``; deepseek-v3's MLA latents keep the pads unmasked, as in
the reference), a bundle the reference built being a cache hit in the
port, and what the engines refuse for this family (MLA cannot page;
qwen3-moe takes the prefix cache and speculative decoding, held to the
reference in ``tests/test_torch_moe_spec_prefix.py``).

The port calibrates and folds on its own for serving (the encoded cases
cover its calibration over MoE and MLA layers: shared experts, dense
prefix, MLA families); the reference's bundle is loaded for the cache
hit.  A continuous prefill chunk is padded to 32 tokens with token 0 and
an idle decode slot feeds token 0, and both count toward MoE capacity
(10 per expert for a chunk at these shapes, 4 for a decode step): the
25 pads of a 7-token prompt's chunk route alike and overflow their
experts.  The port feeds the same padding, so its drops and tokens are
the reference's.
"""
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
from repro.models import init_model as j_init  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa: E402
from repro.serve.engine import ServeEngine as JServe  # noqa: E402

import repro_torch.nn.moe as TMOE  # noqa: E402
from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import apply_model as t_apply  # noqa: E402
from repro_torch.models import (params_from_jax,  # noqa: E402
                                supports_paged_cache, supports_ragged_mask)
from repro_torch.serve import (Engine as TEngine, ServeEngine as TServe,  # noqa: E402
                               arch_families, exact_encodings, generate,
                               prepare_encoded_serving)

TOL = dict(rtol=1e-4, atol=1e-4)
QWEN, DSV3 = "qwen3-moe-235b-a22b", "deepseek-v3-671b"
ARCHS = (QWEN, DSV3)
MODES = ("fp", "encoded")


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


_BUILT = {}


def _build(name, tmp_path_factory):
    """One arch's reduced reference params (fp; encoded-exact with the
    reference's bundle) and the port's: fp through the bridge, encoded
    both bridged (for logits) and calibrated and folded by the port."""
    if name in _BUILT:
        return _BUILT[name]
    jcfg = jget(name).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tget(name).reduced()
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    override = {n: mac for n in arch_families(tcfg)}
    ref_dir = str(tmp_path_factory.mktemp("ref"))
    jpe, jce, jinfo = j_prepare(jp, jcfg, macs_override=override,
                                cache_dir=ref_dir, verbose=False)
    tp = params_from_jax(_to_np(jp), tcfg, "cpu")
    tpe, tce, tinfo = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(families=arch_families(tcfg)),
        device="cpu", cache_dir=str(tmp_path_factory.mktemp("own")),
        verbose=False)
    _BUILT[name] = {
        "name": name, "ref_dir": ref_dir, "jinfo": jinfo, "tinfo": tinfo,
        "fp": ((jp, jcfg), (tp, tcfg), tp),
        "encoded": ((jpe, jce), (tpe, tce),
                    params_from_jax(_to_np(jpe), tcfg, "cpu"))}
    return _BUILT[name]


@pytest.fixture(scope="module", params=ARCHS)
def arch(request, tmp_path_factory):
    return _build(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def qwen(tmp_path_factory):
    return _build(QWEN, tmp_path_factory)


def test_config_matches_reference():
    names = [f.name for f in dataclasses.fields(ModelConfig)
             if f.name not in ("mac", "attention_backend")]
    for name in ARCHS:
        for reduce in (False, True):
            j, t = jget(name), tget(name)
            if reduce:
                j, t = j.reduced(), t.reduced()
            assert {n: getattr(t, n) for n in names} == \
                {n: getattr(j, n) for n in names}, (name, reduce)
            assert t.approx_params() == j.approx_params()
            assert (t.head_dim_r, t.n_heads_p, t.n_kv_p, t.vocab_p) == \
                (j.head_dim_r, j.n_heads_p, j.n_kv_p, j.vocab_p)
    assert supports_paged_cache(tget(QWEN)) and supports_ragged_mask(
        tget(QWEN))
    assert not supports_paged_cache(tget(DSV3))
    assert not supports_ragged_mask(tget(DSV3))
    cut = tget(DSV3).with_layers(2)
    assert (cut.n_layers, cut.first_k_dense) == (2, 1)


@pytest.mark.parametrize("mode", MODES)
def test_logits_match_reference(arch, mode):
    (jp, jcfg), (_, tcfg), bridged = arch[mode]
    toks = np.random.default_rng(5).integers(0, 512, (2, 70)).astype(
        np.int32)
    jl, _, jaux = j_apply(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _, taux = t_apply(bridged, tcfg, torch.from_numpy(toks),
                              return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_own_fold_covers_the_moe_families(arch):
    """The port's calibration records what the reference's does: every
    attention (or MLA) linear, the dense prefix's MLP, the shared expert
    and the untied head, never the router or the routed experts."""
    info = arch["tinfo"]
    if arch["name"] == QWEN:            # 2 layers x (wq wk wv wo) + head
        assert info["n_folded"] == 2 * 4 + 1
    else:                               # 2 x 7 MLA + 3 mlp + 3 shared + head
        assert info["n_folded"] == 2 * 7 + 3 + 3 + 1
    pe = arch["encoded"][1][0]
    for layer in pe["layers"]:
        moe = layer.get("moe")
        if moe is not None:
            assert not any(k.endswith("_fw") for k in moe["router"])
            assert "experts_wi_fw" not in moe


def _trace():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (40, 13, 35, 7, 50)]


@pytest.mark.parametrize("mode", MODES)
def test_static_engine_matches_reference(arch, mode):
    """The reference's static engine over a ragged trace (left-padded;
    qwen3-moe masks the pads, deepseek-v3's MLA does not) gives the
    tokens; the port's must give them."""
    (jp, jcfg), (tp, tcfg), _ = arch[mode]
    trace = _trace()
    want = [np.asarray(w) for w in
            JServe(jp, jcfg, batch_slots=2).run(trace, max_new=6)]
    got = TServe(tp, tcfg, batch_slots=2, device="cpu").run(trace,
                                                           max_new=6)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"static {i}")


def _state(eng):
    reqs = tuple((rid, r.state, r.slot, r.n_cached, tuple(r.pages),
                  tuple(r.out), r.n_evictions)
                 for rid, r in sorted(eng.requests.items()))
    slots = tuple(None if r is None else r.rid for r in eng.sched.slots)
    return reqs, slots, eng.sched.n_evictions


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("mode", MODES)
def test_continuous_engine_matches_reference(qwen, mode, kv_dtype,
                                             monkeypatch):
    """qwen3-moe on the continuous engines (optimistic reserve over a pool
    that forces an eviction, prompts past one prefill chunk, the fused
    paged op): admissions, page tables and lens after every step, and the
    tokens.  The pads of a short prompt's chunk overflow their experts'
    capacity, so the port's own drops are counted (> 0)."""
    (jp, jcfg), (tp, tcfg), _ = qwen[mode]
    drops = []
    plan = TMOE.dispatch_plan

    def counted(idx, n_experts, cap):
        out = plan(idx, n_experts, cap)
        drops.append(int((~out[2]).sum()))
        return out
    monkeypatch.setattr(TMOE, "dispatch_plan", counted)
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype,
                               attention_backend="pallas")
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv_dtype,
                               attention_backend="kernel")
    kw = dict(n_slots=3, page_size=8, n_pages=13, max_seq_pages=12,
              reserve="optimistic", prefill_chunk=32)
    je = JEngine(jp, jcfg, **kw)
    te = TEngine(tp, tcfg, device="cpu", **kw)
    for p in _trace():
        assert je.submit(p, max_new=12) == te.submit(p, max_new=12)
    steps = 0
    while je.busy or te.busy:
        je.step()
        te.step()
        steps += 1
        assert _state(te) == _state(je), f"step {steps}"
        np.testing.assert_array_equal(te.kv.ptab, je.kv.ptab)
        np.testing.assert_array_equal(te.kv.lens, je.kv.lens)
        assert steps < 500
    assert te.stats()["evictions"] == je.stats()["evictions"] >= 1
    jr, tr = je.results(), te.results()
    assert sorted(jr) == sorted(tr) == list(range(5))
    for rid in jr:
        assert tr[rid].tolist() == jr[rid].tolist(), rid
    assert sum(drops) > 0


def test_reference_bundle_is_a_cache_hit(arch):
    """The bundle the reference built (exact encoding for every family of
    the arch) loads in the port: the same key, the port's own fold's
linears (counted per layer), its
    folded leaves (f32, rounded to bf16), and the reference's greedy
    static tokens."""
    (jp, jcfg), (tp, tcfg), _ = arch["fp"]
    pe, ce, info = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(families=arch_families(tcfg)),
        cache_dir=arch["ref_dir"], device="cpu", verbose=False)
    assert info["loaded"]
    assert info["bundle_dir"] == arch["jinfo"]["bundle_dir"]
    assert info["n_folded"] == arch["tinfo"]["n_folded"]
    (jpe, jce), _, _ = arch["encoded"]
    stage = "moe_stack"
    sub = ("mla", "wkv_a_fw") if tcfg.use_mla else ("attn", "wq_fw")
    src = np.asarray(jnp.asarray(jpe[stage][sub[0]][sub[1]]).astype(
        jnp.bfloat16), np.float32)
    first = tcfg.first_k_dense
    for i in range(tcfg.n_layers - first):
        got = pe["layers"][first + i][sub[0]][sub[1]]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), src[i])
    trace = _trace()
    want = [np.asarray(w) for w in
            JServe(jpe, jce, batch_slots=2).run(trace, max_new=6)]
    got = TServe(pe, ce, batch_slots=2, device="cpu").run(trace, max_new=6)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_engines_refuse_what_the_family_cannot_do(arch):
    (_, _), (tp, tcfg), _ = arch["fp"]
    if arch["name"] == DSV3:
        with pytest.raises(ValueError, match="cannot serve paged"):
            TEngine(tp, tcfg, device="cpu")
        with pytest.raises(ValueError, match="pad_lens"):
            generate(tp, tcfg, np.zeros((2, 4), np.int32), max_new=2,
                     pad_lens=[1, 0])
        return
    # qwen3-moe pages, and takes the prefix cache and spec decoding as the
    # reference's Engine does (tests/test_torch_moe_spec_prefix.py holds
    # both to the reference)
    for kw in (dict(prefix_cache=True), dict(spec_decode=2)):
        eng = TEngine(tp, tcfg, device="cpu", **kw)
        assert (eng.sched.prefix is not None) == ("prefix_cache" in kw)
        assert eng.spec_k == kw.get("spec_decode", 0)
        assert ("verify" in eng.steps) == bool(eng.spec_k)


def test_fold_by_columns_equals_one_pass(monkeypatch):
    """A wide weight is folded in column slices (bounded f32
    temporaries); the slices give the one-pass fold bit for bit."""
    from repro_torch.serve import encoded as TE
    mac = exact_encodings()["wq"]
    g = torch.Generator().manual_seed(3)
    wc = torch.randint(-127, 128, (24, 50), generator=g).to(torch.int8)
    s = torch.as_tensor(np.asarray(mac.spec.s, np.float32))
    Wt, b = mac.program.fold_weights(wc, s)
    U = mac.program.n_a_planes
    for cols in (1, 7, 49):
        monkeypatch.setattr(TE, "_FOLD_BYTES", 4 * U * 24 * cols)
        w2, b2 = TE._fold_by_columns(mac.program, wc, s)
        assert torch.equal(w2, Wt.to(torch.bfloat16))
        assert torch.equal(b2, b)


@pytest.mark.parametrize("arch", ARCHS + ("qwen1.5-0.5b",))
def test_input_specs_and_runnable_match_reference(arch):
    """``models/registry.py``: every shape cell's input shapes and dtypes,
    and which cells run, as the reference's."""
    from repro.configs.base import SHAPES as JSHAPES
    from repro.models.registry import input_specs as j_specs
    from repro.models.registry import runnable as j_runnable
    from repro_torch.configs import SHAPES
    from repro_torch.models import input_specs, runnable
    assert sorted(SHAPES) == sorted(JSHAPES)
    jc, tc = jget(arch), tget(arch)
    for name, shape in SHAPES.items():
        want = j_specs(jc, JSHAPES[name])
        got = input_specs(tc, shape)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (s, str(d).replace("torch.", ""))
                for k, (s, d) in got.items()}
        assert runnable(tc, shape) == j_runnable(jc, JSHAPES[name])
