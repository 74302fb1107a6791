"""Port parity for the trainer (``repro_torch.train``) against
``repro.train`` on the CPU: fake-quant and the STE round, the encoded QAT
matmul and its gradients, the executors' suffix schemas, and whole train
steps on reduced qwen1.5-0.5b and gemma2-27b (softcap, sliding window)
in the fp, int8 and encoded MAC modes, from the reference's
``init_train_state`` carried across by ``train_state_from_jax``.

Tolerances (set beforehand from the dtypes, then measured):

* fake_quant values bit for bit, gradients bit for bit (the clip passes
  0.5 at ±qmax, as ``jnp.clip``);
* encoded_matmul_qat values within rtol 1e-5, gradients in x, w and s
  within rtol 1e-4 (f32 sums in another order);
* train steps: loss, gnorm and lr per step within 1e-5 relative (lr bit
  for bit); params and optimizer moments within rtol 5e-4 / atol 5e-5
  after each step.  The encoded mode's gnorm within 1e-4: once the
  trained position weights ``_s`` leave the exact circuit's integers, the
  f32 fold sums terms up to 2^14 times the operands that cancel
  (two's-complement planes), and two summation orders part by about 1e-5
  of a linear's output (measured on reduced qwen1.5-0.5b at step 3:
  linear inputs 1e-5 apart, gradients 3.5e-5 apart globally, gnorm
  1.4e-5, no int8 code moved, loss equal).
  In the int8 and encoded modes, activations are rounded to int8 codes, so
  two f32 summation orders may put one value on either side of a .5
  rounding boundary; from then on the two runs part.  A step whose loss or
  gnorm parts beyond 1e-5 must therefore start at such a code: both
  packages' forwards on the reference's state before that step are read at
  every linear's input, and the first int8 code that differs must sit
  within ``ORIGIN_TOL`` of a .5 boundary on both sides.  The steps before
  it are held to the tolerances above; after it the two runs are printed,
  not compared (ROADMAP Queue C).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import macexec as JX  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.layers import MacConfig as JMac  # noqa: E402
from repro.core.mac import EncodedMac as JEnc  # noqa: E402
from repro.core.mac import encoded_matmul_qat as j_qat  # noqa: E402
from repro.core.search import random_search as j_random_search  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.nn.common import linear_init as j_linear_init  # noqa: E402
from repro.nn.common import set_activation_recorder  # noqa: E402
from repro.quant.uniform import fake_quant as j_fake_quant  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import macexec as TX  # noqa: E402
from repro_torch.core.circuits import Circuit  # noqa: E402
from repro_torch.core.encoding import EncodingSpec as TSpec  # noqa: E402
from repro_torch.core.layers import MacConfig as TMac  # noqa: E402
from repro_torch.core.mac import EncodedMac as TEnc  # noqa: E402
from repro_torch.core.mac import encoded_matmul_qat as t_qat  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import (apply_model, init_model,  # noqa: E402
                                params_from_jax, train_state_from_jax,
                                unstack_layers)
from repro_torch.nn.common import activation_recorder  # noqa: E402
from repro_torch.nn.common import linear_init as t_linear_init  # noqa: E402
from repro_torch.quant.uniform import fake_quant as t_fake_quant  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.train import (init_train_state, make_train_step,  # noqa: E402
                               params_of)

STEP_RTOL = 1e-5
GNORM_RTOL = {"fp": 1e-5, "int8": 1e-5, "encoded": 1e-4}
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
# a parting's first differing int8 code: its value before rounding within
# this of a .5 boundary in both packages (x / scale units)
ORIGIN_TOL = 1e-3
# per layer, the order in which the forward calls the linears
CALLS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
         ("mlp", "wi"), ("mlp", "wg"), ("mlp", "wo"))


def _macs(kind):
    """The same encoding in both packages: the exact AND-plane circuit or
    a small search's circuit with its fitted position weights."""
    if kind == "exact":
        circ, s = exact_product_circuit(8, 8)
        jm = JEnc.from_spec(EncodingSpec(circ, s, 0.0))
    else:
        jm = JEnc.from_spec(j_random_search(0, 24, 8).spec)
    tm = TEnc.from_spec(TSpec(Circuit.from_json(jm.spec.circuit.to_json()),
                              np.asarray(jm.spec.s, np.float32),
                              float(jm.spec.rmse)))
    return jm, tm


@pytest.fixture(scope="module")
def exact_macs():
    return _macs("exact")


def _cfgs(arch, mode, macs):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    if mode != "fp":
        jm, tm = macs if mode == "encoded" else (None, None)
        jc = dataclasses.replace(jc, mac=JMac(mode=mode, mac=jm))
        tc = dataclasses.replace(tc, mac=TMac(mode=mode, mac=tm))
    return jc, tc


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --- quantization and the QAT matmul ----------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_fake_quant_value_and_gradient(bits):
    """Values and STE gradients equal the reference's, with the ±qmax tie
    (the max-abs weight at scale max|w|/qmax) passing 0.5."""
    qm = (1 << (bits - 1)) - 1
    rng = np.random.default_rng(bits)
    x = rng.normal(size=(6, 7)).astype(np.float32)
    x.flat[0] = np.abs(x).max() * 1.5          # lands on +qmax exactly
    x.flat[1] = -x.flat[0]                     # on -qmax
    x.flat[2] = x.flat[0] * 3                  # clipped: no gradient
    scale = np.float32(np.abs(x.flat[0]) / qm)
    g = rng.normal(size=x.shape).astype(np.float32)
    jv, jvjp = jax.vjp(lambda v: j_fake_quant(v, scale, bits), x)
    xt = torch.from_numpy(x.copy()).requires_grad_()
    tv = t_fake_quant(xt, torch.tensor(scale), bits)
    tv.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tv.detach().numpy(), np.asarray(jv))
    jg = np.asarray(jvjp(jnp.asarray(g))[0])
    np.testing.assert_array_equal(xt.grad.numpy(), jg)
    np.testing.assert_array_equal(jg.flat[:3], [0.5 * g.flat[0],
                                                0.5 * g.flat[1], 0.0])


@pytest.mark.parametrize("kind", ["exact", "searched"])
def test_encoded_matmul_qat_matches(kind):
    jm, tm = _macs(kind)
    rng = np.random.default_rng(7)
    m, k, n = 9, 24, 11
    x = rng.normal(size=(m, k)).astype(np.float32) * 2
    w = rng.normal(size=(k, n)).astype(np.float32) * 0.1
    sx = np.float32(np.abs(x).max() / 127)
    sw = np.float32(np.abs(w).max() / 127)
    s = np.asarray(jm.spec.s, np.float32)
    g = rng.normal(size=(m, n)).astype(np.float32)

    def f(x, w, s):
        return j_qat(x, w, sx, sw, s, jm.program)
    jv, jvjp = jax.vjp(f, x, w, s)
    jgx, jgw, jgs = (np.asarray(a) for a in jvjp(jnp.asarray(g)))
    xt, wt, st = (torch.from_numpy(a.copy()).requires_grad_()
                  for a in (x, w, s))
    tv = t_qat(xt, wt, torch.tensor(sx), torch.tensor(sw), st, tm.program)
    tv.backward(torch.from_numpy(g))
    top = np.abs(np.asarray(jv)).max()
    np.testing.assert_allclose(tv.detach().numpy(), np.asarray(jv),
                               rtol=1e-5, atol=1e-5 * top)
    for got, ref in ((xt.grad, jgx), (wt.grad, jgw), (st.grad, jgs)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    assert np.abs(jgs).max() > 0                 # s is trained


@pytest.mark.parametrize("mode", ["fp", "int8", "encoded"])
def test_executor_suffix_schema_matches_reference(mode, exact_macs):
    jm, tm = exact_macs
    jp = j_linear_init(jax.random.PRNGKey(0), 8, 16, "wq",
                       JMac(mode=mode, mac=jm), bias=True)
    tp = t_linear_init(torch.Generator().manual_seed(0), 8, 16, "wq",
                       TMac(mode=mode, mac=tm), bias=True)
    assert set(tp) == set(jp)
    assert TX.get_executor(mode).param_suffixes == \
        JX.get_executor(mode).param_suffixes
    for k in jp:
        assert tuple(tp[k].shape) == np.asarray(jp[k]).shape
        if k != "wq":                           # aux leaves: the same values
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # per_layer_s off: no _s leaf, the shared s_init instead
    tp = t_linear_init(torch.Generator().manual_seed(0), 8, 16, "wq",
                       TMac(mode=mode, mac=tm, per_layer_s=False))
    assert "wq_s" not in tp
    assert TMac(mode="fp").with_mode(mode).mode == mode


def test_params_from_jax_carries_aux_leaves(exact_macs):
    jc, tc = _cfgs("qwen1.5-0.5b", "encoded", exact_macs)
    st = _np_tree(j_init_state(jax.random.PRNGKey(0), jc))
    tp = params_from_jax(st["params"], tc, "cpu")
    for i in range(tc.n_layers):
        for sub, name in CALLS:
            for suf in ("_s", "_as"):
                np.testing.assert_array_equal(
                    tp["layers"][i][sub][name + suf].numpy(),
                    st["params"]["stack"][sub][name + suf][i])
    ts = train_state_from_jax(st, "cpu")
    assert [tuple(t.shape) for t in tree_leaves(ts)] == \
        [a.shape for a in jax.tree_util.tree_leaves(st)]
    assert ts["step"].dtype == torch.int32
    # the port's own init: the reference's leaves, shapes and aux values
    own = init_train_state(tc, seed=0, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [a.shape for a in jax.tree_util.tree_leaves(st)]


# --- whole train steps ----------------------------------------------------

def _inputs_over_scale_ref(jparams, jcfg, tokens):
    """Every linear's input over its activation scale, in forward order,
    from the reference's eager unrolled forward."""
    cfg = dataclasses.replace(jcfg, scan_layers=False, remat=False)
    xs = []
    prev = set_activation_recorder(lambda n, w, x: xs.append(np.asarray(x)))
    try:
        j_apply(jparams, cfg, jnp.asarray(tokens))
    finally:
        set_activation_recorder(prev)
    return _over_scale(xs, jparams["stack"])


def _inputs_over_scale_port(tparams, tcfg, tokens):
    xs = []
    with torch.no_grad(), activation_recorder(
            lambda n, w, x: xs.append(x.numpy().copy())):
        apply_model(unstack_layers(tparams), tcfg, torch.as_tensor(tokens))
    return _over_scale(xs, tparams["stack"])


def _over_scale(xs, stack):
    assert len(xs) % len(CALLS) == 0
    out = []
    for c, x in enumerate(xs):
        sub, name = CALLS[c % len(CALLS)]
        sa = np.asarray(stack[sub][name + "_as"])[c // len(CALLS)]
        out.append((f"layer {c // len(CALLS)} {sub}/{name}",
                    np.asarray(x, np.float32) / np.float32(sa)))
    return out


def _first_code_flip(ref, port):
    """The first linear input (forward order) and element where the two
    forwards' int8 codes differ: (site, ref value, port value), or
    None."""
    for (site, a), (_, b) in zip(ref, port):
        ca = np.clip(np.round(a), -127, 127)
        cb = np.clip(np.round(b), -127, 127)
        diff = np.flatnonzero(ca != cb)
        if diff.size:
            i = diff[0]
            return site, float(a.flat[i]), float(b.flat[i])
    return None


def _edge(v: float) -> float:
    """Distance of ``v`` from the nearest .5 rounding boundary."""
    return abs(v - (np.floor(v) + 0.5))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(a)), 1e-30)


def _close_states(jst, tst, what):
    for a, b in zip(jax.tree_util.tree_leaves(jst), tree_leaves(tst)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=what,
                                   **PARAM_TOL)


def _run_pair(jc, tc, steps, S, B=2, seed=0, **kw):
    """Both packages' train steps from the reference's initial state:
    per step (ref metrics, port metrics, ref state before the step,
    batch), and the final states."""
    jst = j_init_state(jax.random.PRNGKey(seed), jc)
    tst = train_state_from_jax(_np_tree(jst), "cpu")
    jstep = jax.jit(j_make_step(jc, warmup=2, total_steps=20, **kw))
    tstep = make_train_step(tc, warmup=2, total_steps=20, **kw)
    ds = SyntheticLMDataset(jc.vocab_size, S, seed=seed)
    for i in range(steps):
        b = ds.batch(i, B)
        before = jst
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        tst, tm = tstep(tst, b)
        yield jm, tm, before, b, jst, tst


CASES = [("qwen1.5-0.5b", mode, 32) for mode in ("fp", "int8", "encoded")]
# gemma2 reduced: window 64, attention chunks of 64, softcaps; S = 80 puts
# the window and the chunked online softmax in the backward
CASES += [("gemma2-27b", mode, 80) for mode in ("fp", "int8", "encoded")]


@pytest.mark.parametrize("arch,mode,S", CASES)
def test_train_steps_match_reference(arch, mode, S, exact_macs):
    jc, tc = _cfgs(arch, mode, exact_macs)
    parted = None
    for i, (jm, tm, before, b, jst, tst) in enumerate(
            _run_pair(jc, tc, 5, S)):
        rel = {k: _rel(jm[k], tm[k]) for k in ("loss", "gnorm", "lr")}
        print(f"{arch} {mode} step {i}: " + ", ".join(
            f"{k} {float(jm[k]):.7g} / {float(tm[k]):.7g}" for k in rel))
        if parted is not None:
            continue
        assert rel["lr"] == 0.0
        if rel["loss"] > STEP_RTOL or rel["gnorm"] > GNORM_RTOL[mode]:
            assert mode != "fp", (i, rel)
            # where the two forwards' codes first part, on the same state
            flip = _first_code_flip(
                _inputs_over_scale_ref(before["params"], jc, b["tokens"]),
                _inputs_over_scale_port(
                    train_state_from_jax(_np_tree(before), "cpu")["params"],
                    tc, b["tokens"]))
            assert flip is not None, (i, rel)
            site, u, v = flip
            print(f"  parts at step {i}: first int8 code apart at {site}: "
                  f"{u!r} / {v!r} before rounding")
            assert max(_edge(u), _edge(v)) <= ORIGIN_TOL, flip
            parted = i
            continue
        _close_states(jst, tst, f"{arch} {mode} state after step {i}")
    if mode == "fp":
        assert parted is None


@pytest.mark.parametrize("mode", ["fp", "encoded"])
def test_remat_equals_no_remat(mode, exact_macs):
    """Per-layer checkpointing recomputes the same forward: the same
    step, bit for bit."""
    _, tc = _cfgs("qwen1.5-0.5b", mode, exact_macs)
    st = init_train_state(tc, seed=1, device="cpu")
    b = SyntheticLMDataset(tc.vocab_size, 32, seed=1).batch(0, 2)
    outs = []
    for remat in (True, False):
        cfg = dataclasses.replace(tc, remat=remat)
        outs.append(make_train_step(cfg, warmup=0)(st, b))
    (s1, m1), (s2, m2) = outs
    for k in ("loss", "gnorm"):
        assert float(m1[k]) == float(m2[k])
    for a, c in zip(tree_leaves(s1), tree_leaves(s2)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def _tiny_train_cfg():
    cfg = tget("qwen1.5-0.5b").reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=64, d_ff=128,
                               vocab_size=128, learning_rate=3e-3)


@pytest.mark.parametrize("mode", ["fp", "encoded"])
def test_microbatch_equals_full_batch(mode, exact_macs):
    """The reference's test (tests/test_serve_train.py) on the port, and
    in the encoded mode."""
    cfg = _tiny_train_cfg()
    if mode != "fp":
        cfg = dataclasses.replace(cfg, mac=TMac(mode=mode,
                                                mac=exact_macs[1]))
    b = SyntheticLMDataset(cfg.vocab_size, seq_len=16, seed=1).batch(0, 8)
    s0 = init_train_state(cfg, seed=2, device="cpu")
    full = make_train_step(cfg)(s0, b)
    mb = make_train_step(dataclasses.replace(cfg, microbatch=2))(s0, b)
    for a, c in zip(tree_leaves(full[0]["params"]),
                    tree_leaves(mb[0]["params"])):
        np.testing.assert_allclose(c.numpy(), a.numpy(), rtol=5e-4,
                                   atol=5e-5)
    with pytest.raises(ValueError, match="multiple"):
        make_train_step(cfg, microbatch=3)(s0, b)


def test_loss_decreases():
    """The reference's test_loss_decreases on the port."""
    cfg = _tiny_train_cfg()
    ds = SyntheticLMDataset(cfg.vocab_size, seq_len=32, seed=0)
    state = init_train_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, warmup=5, total_steps=60)
    losses = []
    for i in range(60):
        state, m = step(state, ds.batch(i, 16))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::10]
    # the trained params serve through the model as is
    lg, _ = apply_model(params_of(state), cfg,
                        torch.as_tensor(ds.batch(0, 2)["tokens"]))
    assert torch.isfinite(lg).all()


def test_mtp_and_grad_compress_raise():
    """Multi-token prediction is ported with the moe family
    (``tests/test_torch_moe_train.py``) and builds a step, which adds its
    loss on a dense arch too; under a mesh it is refused (TP of the
    other families, ROADMAP Queue A item 3).  ``grad_compress`` without a
    mesh carries zero error buffers and does not quantize, as the
    reference's step (several ranks: ``tests/test_torch_grad_compress.py``)."""
    from repro_torch.parallel.statesharding import check_trainable
    cfg = _tiny_train_cfg()
    mtp = dataclasses.replace(cfg, mtp=True)
    st = init_train_state(mtp, seed=0, device="cpu")
    assert "mtp" in st["params"]
    b = SyntheticLMDataset(cfg.vocab_size, seq_len=16, seed=1).batch(0, 2)
    _, m = make_train_step(mtp)(st, b)
    assert np.isfinite(float(m["loss"]))
    with pytest.raises(NotImplementedError, match="Queue A, item 3"):
        check_trainable(mtp)
    gst = init_train_state(cfg, device="cpu", grad_compress=True)
    plain, _ = make_train_step(cfg)(init_train_state(cfg, device="cpu"), b)
    comp, _ = make_train_step(cfg, grad_compress=True)(gst, b)
    assert all(float(e.abs().max()) == 0 for e in tree_leaves(comp["err"]))
    for a, c in zip(tree_leaves(plain["params"]), tree_leaves(comp["params"])):
        assert torch.equal(a, c)


def test_init_model_makes_aux_leaves(exact_macs):
    _, tc = _cfgs("qwen1.5-0.5b", "int8", exact_macs)
    p = init_model(tc, seed=0, device="cpu")
    assert float(p["layers"][0]["attn"]["wq_as"]) == 1.0
    _, tc = _cfgs("qwen1.5-0.5b", "encoded", exact_macs)
    p = init_model(tc, seed=0, device="cpu")
    np.testing.assert_array_equal(p["layers"][1]["mlp"]["wo_s"].numpy(),
                                  exact_macs[1].s_init)
