"""Port parity for the vlm family's image input (reduced
phi-3-vision-4.2b on the CPU): patch embeddings replacing the prompt's
leading ``min(n_patches, S)`` positions in ``apply_model`` (logits, rtol =
atol = 1e-4), through a prefill into the dense cache and the decode steps
after it, through ``generate``'s ``extras`` (greedy tokens identical), and
in the trainer's batch (3 fp steps, the tolerances of
``tests/test_torch_train.py``), all against the JAX package; and the serve
CLI's ``--mac int8`` (the int8 fake-quant executor) on both engines,
whose tokens must be the reference CLI's from the same weights."""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.models as TM  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.layers import MacConfig as JMac  # noqa: E402
from repro.launch import serve as jcli  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import init_cache as j_cache  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve.engine import generate as j_generate  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.models import (apply_model, init_cache,  # noqa: E402
                                params_from_jax, train_state_from_jax)
from repro_torch.serve import generate  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
ARCH = "phi-3-vision-4.2b"


def _to_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return (jp, jcfg), (params_from_jax(_to_np(jp), tcfg, "cpu"), tcfg)


def _img(B, cfg, seed=1):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)


def _tokens(B, S, seed=5):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("S", [40, 9])
def test_logits_with_image_match_reference(models, S):
    """Patches lead the prompt (S = 9 < 16 patches keeps 9 of them); the
    image moves the logits."""
    (jp, jcfg), (tp, tcfg) = models
    toks, img = _tokens(2, S), _img(2, tcfg)
    jl, _, _ = j_apply(jp, jcfg, jnp.asarray(toks), img=jnp.asarray(img))
    with torch.inference_mode():
        tl, _ = apply_model(tp, tcfg, torch.from_numpy(toks),
                            img=torch.from_numpy(img))
        plain, _ = apply_model(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert not torch.allclose(tl, plain)


def test_prefill_with_image_then_decode_matches_reference(models):
    (jp, jcfg), (tp, tcfg) = models
    toks, img = _tokens(2, 30), _img(2, tcfg)
    jc = j_cache(jcfg, 2, 48)
    tc = init_cache(tcfg, 2, 48, device="cpu")
    jl, jc, _ = j_apply(jp, jcfg, jnp.asarray(toks), img=jnp.asarray(img),
                        cache=jc)
    with torch.inference_mode():
        tl, tc = apply_model(tp, tcfg, torch.from_numpy(toks),
                             img=torch.from_numpy(img), cache=tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for i in range(3):
        nxt = jnp.argmax(jl[:, -1:, :tcfg.vocab_size], -1).astype(jnp.int32)
        jl, jc, _ = j_apply(jp, jcfg, nxt, cache=jc)
        with torch.inference_mode():
            tl, tc = apply_model(tp, tcfg, torch.from_numpy(np.array(nxt)),
                                 cache=tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"decode {i}", **TOL)


def test_generate_with_image_matches_reference(models):
    (jp, jcfg), (tp, tcfg) = models
    toks, img = _tokens(3, 24), _img(3, tcfg)
    want = np.asarray(j_generate(jp, jcfg, jnp.asarray(toks), max_new=8,
                                 extras={"img": jnp.asarray(img)}))
    got = generate(tp, tcfg, toks, max_new=8, extras={"img": img}).numpy()
    np.testing.assert_array_equal(got, want)
    plain = generate(tp, tcfg, toks, max_new=8).numpy()
    assert not np.array_equal(plain, got)


def test_train_steps_with_image_match_reference(models):
    """The batch's ``img`` reaches the loss's forward (3 fp steps)."""
    (_, jcfg), (_, tcfg) = models
    jst = j_init_state(jax.random.PRNGKey(0), jcfg)
    tst = train_state_from_jax(_to_np(jst), "cpu")
    jstep = jax.jit(j_make_step(jcfg, warmup=2, total_steps=20))
    tstep = make_train_step(tcfg, warmup=2, total_steps=20)
    for i in range(3):
        b = {"tokens": _tokens(2, 32, seed=10 + i),
             "labels": _tokens(2, 32, seed=20 + i),
             "img": _img(2, tcfg, seed=30 + i)}
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        tst, tm = tstep(tst, b)
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=f"{k} {i}")
        for a, c in zip(jax.tree_util.tree_leaves(jst), tree_leaves(tst)):
            np.testing.assert_allclose(c.numpy(), np.asarray(a),
                                       err_msg=f"step {i}", **PARAM_TOL)


@pytest.mark.parametrize("engine", [[], ["--continuous"]])
def test_cli_mac_int8_matches_reference(engine, monkeypatch, capsys):
    """``--mac int8 --reduced`` on the static and the continuous engine:
    the port's CLI, given the reference CLI's weights (its
    ``init_model(PRNGKey(0))`` in int8 mode, bridged), prints the
    reference CLI's tokens."""
    name = "qwen1.5-0.5b"
    jcfg = dataclasses.replace(jget(name).reduced(), mac=JMac(mode="int8"))
    jp = _to_np(j_init(jax.random.PRNGKey(0), jcfg))

    def bridged(cfg, *, seed=0, device=None, init_device="cpu"):
        assert cfg.mac.mode == "int8"
        return params_from_jax(jp, cfg, device)
    argv = ["--reduced", "--mac", "int8", "--requests", "5", "--max-new",
            "6"] + engine
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jcli.main()
    want = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(("req", "served"))]
    monkeypatch.setattr(TM, "init_model", bridged)
    tcli.main(argv + ["--device", "cpu"])
    got = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith(("req", "served"))]
    assert len(got) == len(want) == 4
    assert got[1:] == want[1:]
    assert "mac=int8" in got[0] and "mac=int8" in want[0]
