"""Port parity for training the moe family on the CPU: 5 train steps of
reduced qwen3-moe-235b-a22b (softmax router, switch-style load-balance
``aux``, q/k-norm) and deepseek-v3-671b (MLA, sigmoid router with a
zero-gradient ``bias``, shared expert, dense prefix, the MTP loss) in the
fp, int8 and encoded MAC modes against ``repro.train``, from the
reference's ``init_train_state``; step checkpoints in the reference's
layout (its ``dense_prefix``/``moe_stack`` stages and ``mtp`` head) both
ways; and the train CLI on a moe arch.

Tolerances, those of ``tests/test_torch_train.py``: loss, aux, gnorm and
lr per step within 1e-5 relative (encoded gnorm 1e-4), params and
optimizer state within rtol 5e-4 / atol 5e-5 after each step.  In the
int8 and encoded modes a step may part further only where the two
forwards part first at a discrete choice that f32 summation order can
move: an int8 activation code within ``ORIGIN_TOL`` of a .5 boundary on
both sides, or a router's top-k at a near-tie (the two experts' selection
scores within ``ROUTE_TIE`` of each other).  Both forwards run on the
reference's state before that step (the model, then the MTP head), and
every linear input and every routing decision is compared in forward
order; the steps before the parting are held to the tolerances above.
"""
import dataclasses
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.nn.moe as JMOE  # noqa: E402
from repro import ckpt as JK  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.layers import MacConfig as JMac  # noqa: E402
from repro.core.mac import EncodedMac as JEnc  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models.lm import mtp_logits as j_mtp  # noqa: E402
from repro.nn.common import set_activation_recorder  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402

import repro_torch.nn.moe as TMOE  # noqa: E402
from repro_torch import ckpt as TK  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.circuits import Circuit  # noqa: E402
from repro_torch.core.encoding import EncodingSpec as TSpec  # noqa: E402
from repro_torch.core.layers import MacConfig as TMac  # noqa: E402
from repro_torch.core.mac import EncodedMac as TEnc  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.models import (apply_model, mtp_logits,  # noqa: E402
                                stack_layers, to_device,
                                train_state_from_jax, unstack_layers)
from repro_torch.nn.common import activation_recorder  # noqa: E402
from repro_torch.tree import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.train import (init_train_state, make_train_step,  # noqa: E402
                               params_of)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v3-671b")
STEP_RTOL = 1e-5
GNORM_RTOL = {"fp": 1e-5, "int8": 1e-5, "encoded": 1e-4}
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
ORIGIN_TOL = 1e-3
# a routing parting: the two experts' selection scores (softmax
# probabilities, or sigmoid scores + bias) within this of each other
ROUTE_TIE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module's torch ops (the suite runs in
    several worker processes on a few cores); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exact_macs():
    circ, s = exact_product_circuit(8, 8)
    jm = JEnc.from_spec(EncodingSpec(circ, s, 0.0))
    tm = TEnc.from_spec(TSpec(Circuit.from_json(jm.spec.circuit.to_json()),
                              np.asarray(jm.spec.s, np.float32), 0.0))
    return jm, tm


def _cfgs(arch, mode, macs):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    if mode != "fp":
        jm, tm = macs if mode == "encoded" else (None, None)
        jc = dataclasses.replace(jc, mac=JMac(mode=mode, mac=jm))
        tc = dataclasses.replace(tc, mac=TMac(mode=mode, mac=tm))
    return jc, tc


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(a)), 1e-30)


def _edge(v: float) -> float:
    return abs(v - (np.floor(v) + 0.5))


# --- where two forwards first part ------------------------------------------

def _whash(w) -> bytes:
    return hashlib.sha1(np.ascontiguousarray(
        np.asarray(w, np.float32)).tobytes()).digest()


def _scales(params) -> dict:
    """{hash of a weight (per layer): its activation scale ``_as``} over a
    reference-layout param tree of numpy leaves."""
    out = {}

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k + "_as" in node:
                w, sa = np.asarray(v), np.asarray(node[k + "_as"])
                if w.ndim == 3:
                    for i in range(w.shape[0]):
                        out[_whash(w[i])] = float(sa[i])
                else:
                    out[_whash(w)] = float(sa)
    walk(params)
    return out


def _events_ref(jparams, jc, tokens, monkeypatch):
    """The reference's forward (eager, unrolled), then its MTP head:
    ("linear", name, x / sa) and ("route", router, x2, idx) in order."""
    sa = _scales(jparams)
    cfg = dataclasses.replace(jc, scan_layers=False, remat=False)
    ev = []
    orig = JMOE.route

    def route(p, x2, c):
        out = orig(p, x2, c)
        ev.append(("route", _np_tree(p["router"]), np.asarray(x2),
                   np.asarray(out[0])))
        return out
    monkeypatch.setattr(JMOE, "route", route)
    prev = set_activation_recorder(lambda n, w, x: ev.append(
        ("linear", n, np.asarray(x, np.float32) / np.float32(sa[_whash(w)]))))
    try:
        tk = jnp.asarray(tokens)
        _, _, _, h = j_apply(jparams, cfg, tk, return_hidden=True)
        if cfg.mtp:
            j_mtp(jparams, cfg, h, tk)
    finally:
        set_activation_recorder(prev)
        monkeypatch.setattr(JMOE, "route", orig)
    return ev


def _events_port(tstate_params, tc, tokens, sa, monkeypatch):
    ev = []
    orig = TMOE.route

    def route(p, x2, c):
        out = orig(p, x2, c)
        ev.append(("route", None, x2.numpy().copy(), out[0].numpy().copy()))
        return out
    monkeypatch.setattr(TMOE, "route", route)
    p = unstack_layers(tstate_params)
    try:
        with torch.no_grad(), activation_recorder(lambda n, w, x: ev.append(
                ("linear", n, x.numpy().astype(np.float32)
                 / np.float32(sa[_whash(w.numpy())])))):
            tk = torch.as_tensor(tokens)
            _, _, h = apply_model(p, tc, tk, return_hidden=True)
            if tc.mtp:
                mtp_logits(p, tc, h, tk)
    finally:
        monkeypatch.setattr(TMOE, "route", orig)
    return ev


def _selection(router, x2, cfg):
    """The reference's selection scores (f32, numpy) of a router call."""
    lg = x2.astype(np.float32) @ np.asarray(router["w"], np.float32)
    if cfg.router_type == "sigmoid":
        return 1.0 / (1.0 + np.exp(-lg)) + np.asarray(router["bias"])
    e = np.exp(lg - lg.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _first_parting(ref, port, cfg):
    """The first event (forward order) at which the two forwards part:
    (kind, where, a, b), or None."""
    assert [e[0] for e in ref] == [e[0] for e in port]
    for i, (a, b) in enumerate(zip(ref, port)):
        if a[0] == "linear":
            ca = np.clip(np.round(a[2]), -127, 127)
            cb = np.clip(np.round(b[2]), -127, 127)
            diff = np.flatnonzero(ca != cb)
            if diff.size:
                j = diff[0]
                return ("code", f"event {i} {a[1]}", float(a[2].flat[j]),
                        float(b[2].flat[j]))
        else:
            bad = np.flatnonzero((np.sort(a[3], 1) != np.sort(b[3], 1))
                                 .any(1))
            if bad.size:
                t = bad[0]
                sel = _selection(a[1], a[2], cfg)[t]
                only = sorted(set(a[3][t]) ^ set(b[3][t]))
                return ("route", f"event {i} token {t} experts {only}",
                        float(sel[only[0]]), float(sel[only[-1]]))
    return None


def _check_origin(jc, tc, before, tokens, monkeypatch):
    ref = _events_ref(before["params"], jc, tokens, monkeypatch)
    port = _events_port(
        train_state_from_jax(before, "cpu")["params"], tc, tokens,
        _scales(before["params"]), monkeypatch)
    part = _first_parting(ref, port, jc)
    assert part is not None, "the steps part with no code or route apart"
    kind, where, u, v = part
    print(f"  first apart: {kind} at {where}: {u!r} / {v!r}")
    if kind == "code":
        assert max(_edge(u), _edge(v)) <= ORIGIN_TOL, part
    else:
        assert abs(u - v) <= ROUTE_TIE, part


# --- whole train steps ------------------------------------------------------

def _run_pair(jc, tc, steps, S, B=2, seed=0):
    jst = j_init_state(jax.random.PRNGKey(seed), jc)
    tst = train_state_from_jax(_np_tree(jst), "cpu")
    jstep = jax.jit(j_make_step(jc, warmup=2, total_steps=20))
    tstep = make_train_step(tc, warmup=2, total_steps=20)
    ds = SyntheticLMDataset(jc.vocab_size, S, seed=seed)
    for i in range(steps):
        b = ds.batch(i, B)
        before = _np_tree(jst)
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        tst, tm = tstep(tst, b)
        yield jm, tm, before, b, jst, tst


@pytest.mark.parametrize("mode", ["fp", "int8", "encoded"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, mode, exact_macs, monkeypatch):
    jc, tc = _cfgs(arch, mode, exact_macs)
    parted = None
    for i, (jm, tm, before, b, jst, tst) in enumerate(
            _run_pair(jc, tc, 5, 32)):
        rel = {k: _rel(jm[k], tm[k]) for k in ("loss", "aux", "gnorm", "lr")}
        print(f"{arch} {mode} step {i}: " + ", ".join(
            f"{k} {float(jm[k]):.7g} / {float(tm[k]):.7g}" for k in rel))
        if parted is not None:
            continue
        assert rel["lr"] == 0.0
        if jc.router_type == "sigmoid":
            assert float(jm["aux"]) == float(tm["aux"]) == 0.0
        if max(rel["loss"], rel["aux"]) > STEP_RTOL \
                or rel["gnorm"] > GNORM_RTOL[mode]:
            assert mode != "fp", (i, rel)
            print(f"  parts at step {i}")
            _check_origin(jc, tc, before, b["tokens"], monkeypatch)
            parted = i
            continue
        for a, c in zip(jax.tree_util.tree_leaves(jst), tree_leaves(tst)):
            np.testing.assert_allclose(c.numpy(), np.asarray(a),
                                       err_msg=f"{arch} {mode} step {i}",
                                       **PARAM_TOL)
    if mode == "fp":
        assert parted is None


def test_moe_state_is_the_reference_tree():
    """The port's own train state has the reference's stages, MTP head,
    router bias and leaf shapes, in the reference's leaf order; params
    round-trip through the per-layer layout; the sigmoid router's bias
    gets a zero gradient and stays at 0 under Adafactor."""
    arch = "deepseek-v3-671b"
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jst = _np_tree(j_init_state(jax.random.PRNGKey(0), jc))
    own = init_train_state(tc, seed=0, device="cpu")
    assert sorted(own["params"]) == sorted(jst["params"]) == \
        ["dense_prefix", "embed", "final_norm_g", "lm_head", "moe_stack",
         "mtp"]
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jst)]
    back = stack_layers(params_of(own), tc)
    for a, c in zip(tree_leaves(own["params"]), tree_leaves(back)):
        assert torch.equal(a, c)
    # Adafactor's state holds tuples and None: to_device keeps them
    moved = to_device(own, "cpu")
    assert tree_flatten(moved)[1] == tree_flatten(own)[1]
    st, m = make_train_step(tc, warmup=1)(
        own, SyntheticLMDataset(tc.vocab_size, 16, seed=2).batch(0, 2))
    assert float(m["aux"]) == 0.0
    assert torch.equal(st["params"]["moe_stack"]["moe"]["router"]["bias"],
                       torch.zeros_like(
                           own["params"]["moe_stack"]["moe"]["router"]
                           ["bias"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_checkpoint_continues_in_port(arch, tmp_path):
    """The reference trains 2 steps and saves; the port restores into its
    own state (every leaf bit for bit) and takes step 3 as the reference
    does."""
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    js = j_init_state(jax.random.PRNGKey(0), jc)
    jstep = jax.jit(j_make_step(jc, warmup=1, total_steps=10))
    ds = SyntheticLMDataset(jc.vocab_size, 16, seed=3)
    for i in range(2):
        js, _ = jstep(js, {k: jnp.asarray(v)
                           for k, v in ds.batch(i, 2).items()})
    JK.save_checkpoint(str(tmp_path), 2, jax.device_get(js))
    ts = TK.restore_checkpoint(str(tmp_path), 2,
                               init_train_state(tc, seed=9, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    b = ds.batch(2, 2)
    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = make_train_step(tc, warmup=1, total_steps=10)(ts, b)
    for k in ("loss", "aux", "gnorm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for a, c in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), **PARAM_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_in_reference(arch, tmp_path):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    ts = init_train_state(tc, seed=1, device="cpu")
    ts, _ = make_train_step(tc)(
        ts, SyntheticLMDataset(tc.vocab_size, 16, seed=3).batch(0, 2))
    TK.save_checkpoint(str(tmp_path), 1, ts)
    like = j_init_state(jax.random.PRNGKey(0), jc)
    js = JK.restore_checkpoint(str(tmp_path), 1, like)
    assert jax.tree_util.tree_structure(js) == \
        jax.tree_util.tree_structure(like)
    for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    js, m = jax.jit(j_make_step(jc))(js, {
        k: jnp.asarray(v) for k, v in
        SyntheticLMDataset(jc.vocab_size, 16, seed=3).batch(1, 2).items()})
    assert np.isfinite(float(m["loss"]))


def test_cli_trains_a_moe_arch(tmp_path):
    """``python -m repro_torch.launch.train --arch deepseek-v3-671b
    --reduced --device cpu`` trains (router + MTP) and resumes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
           "--device", "cpu", "--arch", "deepseek-v3-671b", "--steps", "2",
           "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
           "--ckpt-every", "1"]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "step 1 loss" in res.stdout and "done" in res.stdout
    res = subprocess.run(cmd[:-4] + ["--steps", "3"] + cmd[-4:], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "resuming from step 2" in res.stdout
