"""Port parity for the encdec family's model (whisper-large-v3: an encoder
over frame embeddings ``enc_x``, a decoder with cross-attention, a tied
head), reduced, on the CPU against the JAX package: the config field for
field; the encoder, the cross K/V and the forward with ``enc_x`` (within
1e-4 of the largest |value|) and its gradients; a prefill that encodes
``enc_x`` into the dense cache, or reads its zero cross K/V, then decode
steps; the cache; the layouts and checkpoints both ways; the input
specs.  Serving, the CLIs, the refusals and training are held in
``tests/test_torch_encdec_serve.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as JK  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models import init_cache as j_cache  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models.registry import input_specs as j_specs  # noqa: E402
from repro.models.registry import runnable as j_runnable  # noqa: E402
from repro.nn import blocks as JB  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train.losses import lm_loss as j_lm_loss  # noqa: E402

from repro_torch import ckpt as TK  # noqa: E402
from repro_torch.configs import SHAPES, ModelConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import (apply_model, init_cache,  # noqa: E402
                                input_specs, layer_kinds, params_from_jax,
                                runnable, stack_layers, unstack_layers)
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.nn import blocks as TB  # noqa: E402
from repro_torch.train import init_train_state  # noqa: E402
from repro_torch.train.losses import lm_loss  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_unflatten)

ARCH = "whisper-large-v3"
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
STEP_RTOL = 1e-5


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


def _enc_x(B, Se, seed=1):
    return np.random.default_rng(seed).normal(size=(B, Se, 128)).astype(
        np.float32)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    # jitted: a fraction of the eager init's compile time
    jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return (jp, jcfg), (params_from_jax(_to_np(jp), tcfg, "cpu"), tcfg)


def test_config_matches_reference():
    names = [f.name for f in dataclasses.fields(ModelConfig)
             if f.name not in ("mac", "attention_backend")]
    for reduce in (False, True):
        j, t = jget(ARCH), tget(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert {n: getattr(t, n) for n in names} == \
            {n: getattr(j, n) for n in names}, reduce
        assert t.layer_windows == j.layer_windows
        assert t.approx_params() == j.approx_params()
    red = tget(ARCH).reduced()
    assert (red.enc_layers, red.dec_layers, red.max_pos_embed) == (2, 2, 2048)
    cut = tget(ARCH).with_layers(4)
    assert (cut.enc_layers, cut.dec_layers, cut.n_layers) == (4, 4, 8)
    assert layer_kinds(cut) == ["encoder"] * 4 + ["xattn"] * 4


def test_sinusoid_is_the_references():
    np.testing.assert_array_equal(TE._sinusoid(1500, 1280),
                                  JE._sinusoid(1500, 1280))


def test_encode_and_cross_kv_match_reference(model):
    """The encoder's normed output over 24 frames, and each decoder
    layer's cross K/V from it."""
    (jp, jcfg), (tp, tcfg) = model
    x = _enc_x(2, 24)
    jo = JE.encode(jp, jcfg, jnp.asarray(x))
    with torch.inference_mode():
        to = TE.encode(tp, tcfg, torch.from_numpy(x))
        _close(to.numpy(), jo)
        for i, p_l in enumerate(tp["layers"][tcfg.enc_layers:]):
            jk, jv = JB.cross_kv(jax.tree_util.tree_map(
                lambda a: a[i], jp["dec"]), jo, jcfg)
            tk, tv = TB.cross_kv(p_l, torch.from_numpy(np.array(jo)), tcfg)
            _close(tk.numpy(), jk, err_msg=f"layer {i} k")
            _close(tv.numpy(), jv, err_msg=f"layer {i} v")


@pytest.mark.parametrize("S", [40, 7])
def test_logits_match_reference(model, S):
    (jp, jcfg), (tp, tcfg) = model
    toks, x = _tokens(S), _enc_x(2, 10)
    jl, _, _ = j_apply(jp, jcfg, jnp.asarray(toks), enc_x=jnp.asarray(x))
    with torch.inference_mode():
        tl, _ = apply_model(tp, tcfg, torch.from_numpy(toks),
                            enc_x=torch.from_numpy(x))
    _close(tl.numpy(), jl)


def test_grads_match_reference(model):
    """The loss and its gradient with respect to every param, remat on as
    in training."""
    (jp, jcfg), (tp, tcfg) = model
    toks, labels, x = _tokens(24, seed=1), _tokens(24, seed=2), _enc_x(2, 6)

    def jloss(p):
        lg, _, _ = j_apply(p, jcfg, jnp.asarray(toks), enc_x=jnp.asarray(x))
        return j_lm_loss(lg, jnp.asarray(labels))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    stacked = stack_layers(tp, tcfg)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(stacked)]
    p = unstack_layers(tree_unflatten(tree_flatten(stacked)[1], leaves))
    lg, _ = apply_model(p, tcfg, torch.from_numpy(toks),
                        enc_x=torch.from_numpy(x))
    tl = lm_loss(lg, torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=STEP_RTOL)
    ref = jax.tree_util.tree_leaves(jg)
    assert len(ref) == len(grads)
    for a, g, t in zip(ref, grads, leaves):
        g = torch.zeros_like(t) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(a), **PARAM_TOL)


@pytest.mark.parametrize("with_enc", [True, False])
def test_prefill_then_decode_matches_reference(model, with_enc):
    """A 30-token prefill into the dense cache, with ``enc_x`` (the cross
    K/V made from 12 frames: new tensors, as the cache holds
    ``max_len // enc_len_ratio`` = 16) or without (the cache's zero cross
    K/V), then 4 decode steps fed the reference's greedy tokens: every
    step's logits, and the cross K/V."""
    (jp, jcfg), (tp, tcfg) = model
    x = _enc_x(2, 12)
    jc = j_cache(jcfg, 2, 64)
    tc = init_cache(tcfg, 2, 64, device="cpu")
    assert tc["layers"][0]["ck"].shape[1] == 16
    feed = jnp.asarray(_tokens(30))
    for i in range(5):
        kw_j = {"enc_x": jnp.asarray(x)} if with_enc and i == 0 else {}
        kw_t = {"enc_x": torch.from_numpy(x)} if with_enc and i == 0 else {}
        jl, jc, _ = j_apply(jp, jcfg, feed, cache=jc, **kw_j)
        with torch.inference_mode():
            tl, tc = apply_model(tp, tcfg, torch.from_numpy(np.array(feed)),
                                 cache=tc, **kw_t)
        _close(tl.numpy(), jl, err_msg=f"step {i}")
        assert int(tc["pos"]) == int(jc["pos"])
        feed = jnp.argmax(jl[:, -1:, :tcfg.vocab_size], -1).astype(
            jnp.int32)
    for i, layer in enumerate(tc["layers"]):
        assert layer["ck"].shape[1] == (12 if with_enc else 16)
        np.testing.assert_allclose(layer["ck"].numpy(), jc["cross"]["ck"][i],
                                   rtol=1e-4, atol=1e-4)


def test_cache_layout_is_the_references():
    """Per decoder layer the self-attention's ``k, v`` and the cross K/V
    ``ck, cv`` in the reference's shapes (it stacks them ``(L, …)``
    under ``layers/self`` and ``cross``)."""
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jc = j_cache(jcfg, 3, 40)
    tc = init_cache(tcfg, 3, 40, device="cpu")
    assert len(tc["layers"]) == tcfg.dec_layers
    for layer in tc["layers"]:
        assert sorted(layer) == ["ck", "cv", "k", "v"]
        for k in ("k", "v"):
            assert tuple(layer[k].shape) == jc["layers"]["self"][k].shape[1:]
        for k in ("ck", "cv"):
            assert tuple(layer[k].shape) == jc["cross"][k].shape[1:]
    assert init_cache(tcfg, 3, 40, device="cpu", enc_len=7)["layers"][0][
        "ck"].shape[1] == 7


def test_layouts_round_trip(model, tmp_path):
    """Params: the reference's tree (``enc`` and ``dec`` stacks,
    ``pos_table``, ``enc_norm``, ``final_norm``) → the port's per-layer
    list → back, leaf for leaf; the port's own train state has the
    reference's tree; checkpoints restore both ways, bit for bit."""
    (jp, jcfg), (tp, tcfg) = model
    ref = _to_np(jp)
    assert len(tp["layers"]) == tcfg.enc_layers + tcfg.dec_layers
    assert "pos_table" in tp and "enc_norm_g" in tp
    back = stack_layers(tp, tcfg)
    assert sorted(back) == sorted(ref)
    assert jax.tree_util.tree_structure(ref) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda t: 0, back, is_leaf=lambda x: isinstance(x,
                                                             torch.Tensor)))
    for a, b in zip(jax.tree_util.tree_leaves(ref), tree_leaves(back)):
        np.testing.assert_array_equal(b.numpy(), a)
    jst = j_init_state(jax.random.PRNGKey(0), jcfg)
    own = init_train_state(tcfg, seed=0, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jst)]
    JK.save_checkpoint(str(tmp_path / "ref"), 1, jax.device_get(jst))
    ts = TK.restore_checkpoint(str(tmp_path / "ref"), 1, own)
    for a, b in zip(jax.tree_util.tree_leaves(jst), tree_leaves(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    TK.save_checkpoint(str(tmp_path / "port"), 1, own)
    js = JK.restore_checkpoint(str(tmp_path / "port"), 1, jst)
    for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(own)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_input_specs_and_runnable_match_reference():
    jc, tc = jget(ARCH), tget(ARCH)
    for name, shape in SHAPES.items():
        want = j_specs(jc, JSHAPES[name])
        got = input_specs(tc, shape)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (s, str(d).replace("torch.", ""))
                for k, (s, d) in got.items()}
        assert runnable(tc, shape) == j_runnable(jc, JSHAPES[name])
    assert input_specs(tc, SHAPES["prefill_32k"])["enc_x"][0] == \
        (32, 8192, 1280)
