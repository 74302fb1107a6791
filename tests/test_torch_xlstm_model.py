"""Port parity for the xlstm family's model in fp (xlstm-1.3b reduced with
one mLSTM and one sLSTM block, ``slstm_every=2``) on the CPU against the
JAX package: ``apply_model`` logits (within 1e-4 of the largest |logit|),
a prefill then decode steps over the dense cache (logits and states),
greedy tokens of ``generate`` and ``ServeEngine`` (identical), gradients
and 5 fp train steps (the tolerances of ``tests/test_torch_train.py``),
and the layouts and checkpoints both ways.  The modules are held in
``tests/test_torch_xlstm.py``, the exact encoding in
``tests/test_torch_xlstm_serve.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as JK  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import init_cache as j_cache  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve.engine import ServeEngine as JServe  # noqa: E402
from repro.serve.engine import generate as j_generate  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402
from repro.train.losses import lm_loss as j_lm_loss  # noqa: E402

from repro_torch import ckpt as TK  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import (apply_model, init_cache,  # noqa: E402
                                layer_kinds, params_from_jax, stack_layers,
                                train_state_from_jax, unstack_layers)
from repro_torch.serve import ServeEngine as TServe, generate  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.train.losses import lm_loss  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_unflatten)

ARCH = "xlstm-1.3b"
REC_TOL = dict(rtol=2e-4, atol=2e-4)
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
def model():
    """The reference's params and the port's, bridged."""
    jcfg, tcfg = _cfgs()
    jp = _j_init(jcfg)
    return (jp, jcfg), (params_from_jax(_to_np(jp), tcfg, "cpu"), tcfg)


def _logits(jp, jcfg, tp, tcfg):
    assert layer_kinds(tcfg) == ["mlstm", "slstm"]
    toks = _tokens(70)
    jl, _, _ = j_apply(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = apply_model(tp, tcfg, torch.from_numpy(toks))
    _close(tl.numpy(), jl)


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
    (jp, jcfg), (tp, tcfg) = model
    _logits(jp, jcfg, tp, tcfg)


def test_prefill_then_decode_matches_reference(model):
    (jp, jcfg), (tp, tcfg) = model
    _prefill_then_decode(jp, jcfg, tp, tcfg)


def test_generate_and_static_engine_match_reference(model):
    (jp, jcfg), (tp, tcfg) = model
    _generate_and_static(jp, jcfg, tp, tcfg, JServe(
        jp, jcfg, batch_slots=3).run(_trace(), max_new=6))


def test_grads_match_reference(model):
    """The loss and its gradient with respect to every param (the
    reference's stacked layout), remat on as in training."""
    (jp, jcfg), (tp, tcfg) = model
    toks, labels = _tokens(24, seed=1), _tokens(24, seed=2)

    def jloss(p):
        lg, _, _ = j_apply(p, jcfg, jnp.asarray(toks))
        return j_lm_loss(lg[:, -24:], jnp.asarray(labels))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    stacked = stack_layers(tp, tcfg)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in tree_leaves(stacked)]
    p = unstack_layers(tree_unflatten(tree_flatten(stacked)[1], leaves))
    lg, _ = apply_model(p, tcfg, torch.from_numpy(toks))
    tl = lm_loss(lg[:, -24:], torch.from_numpy(labels))
    grads = torch.autograd.grad(tl, leaves, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=STEP_RTOL)
    ref = jax.tree_util.tree_leaves(jg)
    assert len(ref) == len(grads)
    for a, g, x in zip(ref, grads, leaves):
        g = torch.zeros_like(x) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(a), **PARAM_TOL)


def test_train_steps_match_reference(model):
    """5 fp train steps from the reference's ``init_train_state``: loss,
    gnorm and lr within 1e-5 relative, every param and optimizer leaf
    within rtol 5e-4 / atol 5e-5 after each step."""
    (_, jcfg), (_, tcfg) = model
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


def test_layouts_round_trip(model, tmp_path):
    """Params: the reference's ``{"xlstm": {"mlstm": …, "slstm": …}}`` →
    the port's per-layer list → back, leaf for leaf; the port's own train
    state has the reference's tree; checkpoints restore both ways, bit
    for bit."""
    (jp, jcfg), (tp, tcfg) = model
    ref = _to_np(jp)
    back = stack_layers(tp, tcfg)
    assert sorted(back["xlstm"]) == ["mlstm", "slstm"]
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
