"""Port parity for the vlm family (phi-3-vision-4.2b: a dense backbone with
an untied head) and the hybrid family (hymba-1.5b: attention and SSM heads
in parallel, meta tokens, a sliding window with global layers, a tied
head), reduced, on the CPU: the configs field for field, ``apply_model``
logits (rtol = atol = 1e-4), gradients and 5 fp train steps (the
tolerances of ``tests/test_torch_train.py``), prefill then decode over the
dense cache, greedy tokens of ``generate`` and ``ServeEngine`` in fp and
with the exact encoding, the port's own fold families and a bundle the
reference built being a cache hit, param, train-state and checkpoint
round trips in the reference's layout, ``input_specs``/``runnable``, and
what the engines refuse (no paging; no ``pad_lens``: SSM state and meta
tokens ingest pads, as in the reference).  The vlm's image input is held
in ``tests/test_torch_vlm.py``, the SSM itself in
``tests/test_torch_hybrid.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as JK  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import init_cache as j_cache  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models.registry import input_specs as j_specs  # noqa: E402
from repro.models.registry import runnable as j_runnable  # noqa: E402
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa: E402
from repro.serve.engine import ServeEngine as JServe  # noqa: E402
from repro.serve.engine import generate as j_generate  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro.train.losses import lm_loss as j_lm_loss  # noqa: E402

from repro_torch import ckpt as TK  # noqa: E402
from repro_torch.configs import SHAPES, ModelConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import (apply_model, init_cache,  # noqa: E402
                                input_specs, params_from_jax, runnable,
                                stack_layers, supports_paged_cache,
                                supports_ragged_mask, to_reference_layout,
                                train_state_from_jax, unstack_layers)
from repro_torch.serve import (Engine as TEngine, ServeEngine as TServe,  # noqa: E402
                               arch_families, exact_encodings, generate,
                               prepare_encoded_serving)
from repro_torch.train import (init_train_state, make_train_step,  # noqa: E402
                               params_of)
from repro_torch.train.losses import lm_loss  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_unflatten)

TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
STEP_RTOL = 1e-5
VLM, HYBRID = "phi-3-vision-4.2b", "hymba-1.5b"
ARCHS = (VLM, HYBRID)
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


@pytest.fixture(scope="module", params=ARCHS)
def arch(request, tmp_path_factory):
    """One arch's reduced reference params (fp; encoded-exact with the
    reference's bundle) and the port's: fp through the bridge, encoded
    both bridged (for logits) and calibrated and folded by the port."""
    name = request.param
    if name in _BUILT:
        return _BUILT[name]
    jcfg = jget(name).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tcfg = tget(name).reduced()
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    ref_dir = str(tmp_path_factory.mktemp("ref"))
    jpe, jce, jinfo = j_prepare(
        jp, jcfg, macs_override={n: mac for n in arch_families(tcfg)},
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


def test_config_matches_reference(arch):
    name = arch["name"]
    names = [f.name for f in dataclasses.fields(ModelConfig)
             if f.name not in ("mac", "attention_backend")]
    for reduce in (False, True):
        j, t = jget(name), tget(name)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert {n: getattr(t, n) for n in names} == \
            {n: getattr(j, n) for n in names}, (name, reduce)
        assert t.layer_windows == j.layer_windows
        assert t.approx_params() == j.approx_params()
        assert (t.head_dim_r, t.n_heads_p, t.n_kv_p, t.vocab_p) == \
            (j.head_dim_r, j.n_heads_p, j.n_kv_p, j.vocab_p)
    assert name in list_archs()
    if name == HYBRID:
        # a depth cut keeps layer 0 global and windows the rest
        assert tget(name).with_layers(4).layer_windows == \
            [None, 2048, 2048, 2048]
        assert tget(name).reduced().layer_windows == [None, 64]
        assert tget(name).reduced().meta_tokens == 8
    else:
        assert tget(name).reduced().n_patches == 16


def _tokens(S, B=2, seed=5):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("mode", MODES)
def test_logits_match_reference(arch, mode):
    """Past the reduced window (64) for hymba, meta tokens included."""
    (jp, jcfg), (_, tcfg), bridged = arch[mode]
    toks = _tokens(90)
    jl, _, _ = j_apply(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = apply_model(bridged, tcfg, torch.from_numpy(toks))
    assert tl.shape[1] == 90 + tcfg.meta_tokens
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_grads_match_reference(arch):
    """One loss and its gradient with respect to every param (the
    reference's stacked layout), remat on as in training."""
    (jp, jcfg), (tp, tcfg), _ = arch["fp"]
    toks = _tokens(24, seed=1)
    labels = _tokens(24, seed=2)

    def jloss(p):
        lg, _, _ = j_apply(p, jcfg, jnp.asarray(toks))
        return j_lm_loss(lg[:, -24:], jnp.asarray(labels))
    jl, jg = jax.value_and_grad(jloss)(jp)
    stacked = stack_layers(tp, tcfg)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(stacked)]
    spec = tree_flatten(stacked)[1]
    p = unstack_layers(tree_unflatten(spec, leaves))
    lg, _ = apply_model(p, tcfg, torch.from_numpy(toks))
    tl = lm_loss(lg[:, -24:], torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=STEP_RTOL)
    ref = jax.tree_util.tree_leaves(jg)
    assert len(ref) == len(grads)
    for a, g, x in zip(ref, grads, leaves):
        g = torch.zeros_like(x) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(a), **PARAM_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_prefill_then_decode_matches_reference(arch, mode):
    """A 40-token prefill into the dense cache (hymba: its meta tokens
    first, the SSM state carried), then 4 decode steps fed the reference's
    greedy tokens: every step's logits."""
    (jp, jcfg), (_, tcfg), bridged = arch[mode]
    toks = _tokens(40)
    jc = j_cache(jcfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    feed = jnp.asarray(toks)
    for i in range(5):
        jl, jc, _ = j_apply(jp, jcfg, feed, cache=jc)
        with torch.inference_mode():
            tl, tc = apply_model(bridged, tcfg,
                                 torch.from_numpy(np.array(feed)),
                                 cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {i}", **TOL)
        assert int(tc["pos"]) == int(jc["pos"])
        feed = jnp.argmax(jl[:, -1:, :tcfg.vocab_size], -1).astype(
            jnp.int32)


def _trace():
    rng = np.random.default_rng(6)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (70, 17, 90)]


@pytest.mark.parametrize("mode", MODES)
def test_generate_and_static_engine_match_reference(arch, mode):
    """``generate`` over a uniform batch, and ``ServeEngine`` over a ragged
    trace (left-padded; the pads stay unmasked, as in the reference)."""
    (jp, jcfg), (tp, tcfg), _ = arch[mode]
    toks = _tokens(30, B=3)
    want = np.asarray(j_generate(jp, jcfg, jnp.asarray(toks), max_new=6))
    got = generate(tp, tcfg, toks, max_new=6).numpy()
    np.testing.assert_array_equal(got, want)
    trace = _trace()
    want = [np.asarray(w) for w in
            JServe(jp, jcfg, batch_slots=2).run(trace, max_new=6)]
    eng = TServe(tp, tcfg, batch_slots=2, device="cpu")
    got = eng.run(trace, max_new=6)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    st = eng.stats()
    assert st["chunks"] == 2 and st["decode_steps"] == 2 * 5


def test_own_fold_covers_the_families(arch):
    """The port's calibration folds what the reference's does: every
    attention and MLP linear, hymba's SSM in-, B/C/dt- and out-projections
    (never its conv, ``wdt`` or meta tokens) and phi-3-vision's untied
    head (hymba's head is tied: fp)."""
    info = arch["tinfo"]
    pe = arch["encoded"][1][0]
    L = len(pe["layers"])
    if arch["name"] == HYBRID:
        assert info["n_folded"] == L * (4 + 3 + 3)
        for layer in pe["layers"]:
            ssm = layer["ssm"]
            assert {k for k in ssm if k.endswith("_fw")} == \
                {"win_fw", "wbcdt_fw", "wout_fw"}
            assert "wdt_fw" not in ssm and "conv_w_fw" not in ssm
        assert "lm_head" not in pe and "meta" in pe
    else:
        assert info["n_folded"] == L * (4 + 3) + 1
        assert "w_fw" in pe["lm_head"]
    assert set(info["families"]) == set(arch_families(arch["fp"][1][1]))


def test_reference_bundle_is_a_cache_hit(arch):
    """The bundle the reference built loads in the port: the same key,
    the port's own fold's count, the reference's folded leaves (rounded
    to bf16) and its greedy static tokens."""
    (_, _), (tp, tcfg), _ = arch["fp"]
    pe, ce, info = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(families=arch_families(tcfg)),
        cache_dir=arch["ref_dir"], device="cpu", verbose=False)
    assert info["loaded"]
    assert info["bundle_dir"] == arch["jinfo"]["bundle_dir"]
    assert info["n_folded"] == arch["tinfo"]["n_folded"]
    (jpe, jce), _, _ = arch["encoded"]
    sub = ("ssm", "wbcdt_fw") if tcfg.family == "hybrid" else \
        ("mlp", "wo_fw")
    src = np.asarray(jnp.asarray(jpe["stack"][sub[0]][sub[1]]).astype(
        jnp.bfloat16), np.float32)
    for i, layer in enumerate(pe["layers"]):
        got = layer[sub[0]][sub[1]]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), src[i])
    trace = _trace()
    want = [np.asarray(w) for w in
            JServe(jpe, jce, batch_slots=2).run(trace, max_new=6)]
    got = TServe(pe, ce, batch_slots=2, device="cpu").run(trace, max_new=6)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_train_steps_match_reference(arch):
    """5 fp train steps from the reference's ``init_train_state``: loss,
    gnorm and lr per step within 1e-5 relative, every param and optimizer
    leaf within rtol 5e-4 / atol 5e-5 after each step."""
    (_, jcfg), (_, tcfg), _ = arch["fp"]
    jst = j_init_state(jax.random.PRNGKey(0), jcfg)
    tst = train_state_from_jax(_to_np(jst), "cpu")
    jstep = jax.jit(j_make_step(jcfg, warmup=2, total_steps=20))
    tstep = make_train_step(tcfg, warmup=2, total_steps=20)
    ds = SyntheticLMDataset(jcfg.vocab_size, 32, seed=0)
    for i in range(5):
        b = ds.batch(i, 2)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        tst, tm = tstep(tst, b)
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_RTOL, err_msg=f"{k} {i}")
        for a, c in zip(jax.tree_util.tree_leaves(jst), tree_leaves(tst)):
            np.testing.assert_allclose(c.numpy(), np.asarray(a),
                                       err_msg=f"step {i}", **PARAM_TOL)


def test_layouts_round_trip(arch, tmp_path):
    """Params: the reference's tree → the port's layout → back, leaf for
    leaf (hymba's ``meta`` and nested ``attn``/``ssm`` included); the
    port's own train state has the reference's tree; a checkpoint the
    reference wrote restores in the port and one the port wrote restores
    in the reference, bit for bit."""
    (jp, jcfg), (tp, tcfg), _ = arch["fp"]
    ref = _to_np(jp)
    back = stack_layers(tp, tcfg)
    assert sorted(back) == sorted(ref)
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda t: 0, back, is_leaf=lambda x: isinstance(x,
                                                             torch.Tensor)))
    for a, b in zip(jax.tree_util.tree_leaves(ref), tree_leaves(back)):
        np.testing.assert_array_equal(b.numpy(), a)
    lay = to_reference_layout(tp, tcfg)
    assert sorted(lay) == sorted(ref)
    jst = j_init_state(jax.random.PRNGKey(0), jcfg)
    own = init_train_state(tcfg, seed=0, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jst)]
    assert sorted(params_of(own)) == sorted(tp)
    JK.save_checkpoint(str(tmp_path / "ref"), 1, jax.device_get(jst))
    ts = TK.restore_checkpoint(str(tmp_path / "ref"), 1, own)
    for a, b in zip(jax.tree_util.tree_leaves(jst), tree_leaves(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    TK.save_checkpoint(str(tmp_path / "port"), 1, own)
    js = JK.restore_checkpoint(str(tmp_path / "port"), 1, jst)
    for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(own)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_input_specs_and_runnable_match_reference(arch):
    jc, tc = jget(arch["name"]), tget(arch["name"])
    for name, shape in SHAPES.items():
        want = j_specs(jc, JSHAPES[name])
        got = input_specs(tc, shape)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (s, str(d).replace("torch.", ""))
                for k, (s, d) in got.items()}
        assert runnable(tc, shape) == j_runnable(jc, JSHAPES[name])
    if arch["name"] == VLM:
        assert input_specs(tc, SHAPES["prefill_32k"])["img"][0] == \
            (32, 256, 3072)


def test_engines_refuse_paging_and_pad_lens(arch):
    """Neither family pages (hymba: SSM state and meta tokens; a vlm is
    not of the paged families), so the continuous engine refuses them and
    ``generate`` refuses ``pad_lens``, as the reference does."""
    (_, _), (tp, tcfg), _ = arch["fp"]
    assert not supports_paged_cache(tcfg)
    assert not supports_ragged_mask(tcfg)
    with pytest.raises(ValueError, match="cannot serve paged"):
        TEngine(tp, tcfg, device="cpu")
    with pytest.raises(ValueError, match="pad_lens"):
        generate(tp, tcfg, np.zeros((2, 4), np.int32), max_new=2,
                 pad_lens=[1, 0])
