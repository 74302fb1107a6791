"""Port parity for the encdec family's serving and training
(whisper-large-v3, reduced) on the CPU against the JAX package: greedy
tokens of ``generate`` with and without ``enc_x`` and of ``ServeEngine``
(identical); both serve CLIs in fp and with ``--mac int8`` (the same
tokens from the same weights); ``--mac encoded`` and a batch without
``enc_x`` refused alike (the calibration and the train CLI's data stream
have no encoder inputs); 5 fp train steps with ``enc_x`` in every batch;
and what the engines refuse.  The model is held in
``tests/test_torch_encdec.py``."""
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
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.layers import MacConfig as JMac  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.launch import serve as jcli  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa: E402
from repro.serve.engine import ServeEngine as JServe  # noqa: E402
from repro.serve.engine import generate as j_generate  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import serve as tcli  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import (params_from_jax,  # noqa: E402
                                supports_paged_cache, supports_ragged_mask,
                                train_state_from_jax)
from repro_torch.serve import (Engine as TEngine, ServeEngine as TServe,  # noqa: E402
                               exact_encodings, generate,
                               prepare_encoded_serving)
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "whisper-large-v3"
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)
STEP_RTOL = 1e-5
REFUSAL = "enc-dec training needs encoder inputs"


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


def test_generate_and_static_engine_match_reference(model):
    """``generate`` with ``enc_x`` (its prefill encodes the frames) and
    without (the zero cross cache), and ``ServeEngine`` over a ragged
    trace (no ``enc_x``, as in the reference): greedy tokens
    identical."""
    (jp, jcfg), (tp, tcfg) = model
    toks, x = _tokens(20, B=3), _enc_x(3, 12)
    want = j_generate(jp, jcfg, jnp.asarray(toks), max_new=6,
                      extras={"enc_x": jnp.asarray(x)})
    got = generate(tp, tcfg, toks, max_new=6, extras={"enc_x": x})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = j_generate(jp, jcfg, jnp.asarray(toks), max_new=6)
    got = generate(tp, tcfg, toks, max_new=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(6)
    trace = [rng.integers(0, 512, n).astype(np.int32) for n in (30, 9, 17)]
    want = JServe(jp, jcfg, batch_slots=3).run(trace, max_new=6)
    eng = TServe(tp, tcfg, batch_slots=3, device="cpu")
    for i, (g, w) in enumerate(zip(eng.run(trace, max_new=6), want)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f"req {i}")


@pytest.mark.parametrize("mac", ["fp", "int8"])
def test_cli_matches_reference(mac, monkeypatch, capsys):
    """``--arch whisper-large-v3 --reduced`` (static, no ``enc_x``, as the
    reference's CLI): the port's CLI, given the reference CLI's weights
    (its ``init_model(PRNGKey(0))``, bridged), prints the reference CLI's
    tokens."""
    jcfg = dataclasses.replace(jget(ARCH).reduced(), mac=JMac(mode=mac))
    jp = _to_np(j_init(jax.random.PRNGKey(0), jcfg))

    def bridged(cfg, *, seed=0, device=None, init_device="cpu"):
        assert cfg.mac.mode == mac
        return params_from_jax(jp, cfg, device)
    argv = ["--arch", ARCH, "--reduced", "--mac", mac, "--requests", "4",
            "--max-new", "5"]
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
    assert f"mac={mac}" in got[0] and f"mac={mac}" in want[0]


def test_encoded_and_encoderless_training_refused_alike(model, tmp_path,
                                                        monkeypatch):
    """The calibration forward has no ``enc_x``, so ``--mac encoded``
    raises the reference's ``AssertionError`` in both packages; so does a
    train step on a batch without ``enc_x``, which is what the train
    CLI's data stream gives (``repro_torch.launch.train``)."""
    (jp, jcfg), (tp, tcfg) = model
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    with pytest.raises(AssertionError, match=REFUSAL):
        j_prepare(jp, jcfg, macs_override={"w": mac},
                  cache_dir=str(tmp_path / "j"), verbose=False)
    with pytest.raises(AssertionError, match=REFUSAL):
        prepare_encoded_serving(tp, tcfg, macs_override=exact_encodings(),
                                cache_dir=str(tmp_path / "t"), device="cpu",
                                verbose=False)
    b = {k: jnp.asarray(v) for k, v in SyntheticLMDataset(
        512, 16, seed=0).batch(0, 2).items()}
    with pytest.raises(AssertionError, match=REFUSAL):
        j_make_step(jcfg)(j_init_state(jax.random.PRNGKey(0), jcfg), b)
    with pytest.raises(AssertionError, match=REFUSAL):
        ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--steps", "1", "--batch", "2", "--seq", "16",
                     "--ckpt-dir", str(tmp_path / "ck")])


def test_train_steps_match_reference(model):
    """5 fp train steps with ``enc_x`` in every batch, from the
    reference's ``init_train_state``: loss, gnorm and lr within 1e-5
    relative, every param and optimizer leaf within rtol 5e-4 / atol 5e-5
    after each step."""
    (_, jcfg), (_, tcfg) = model
    jst = j_init_state(jax.random.PRNGKey(0), jcfg)
    tst = train_state_from_jax(_to_np(jst), "cpu")
    jstep = jax.jit(j_make_step(jcfg, warmup=2, total_steps=20))
    tstep = make_train_step(tcfg, warmup=2, total_steps=20)
    ds = SyntheticLMDataset(jcfg.vocab_size, 32, seed=0)
    for i in range(5):
        b = dict(ds.batch(i, 2), enc_x=_enc_x(2, 8, seed=10 + i))
        jst, jm = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        tst, tm = tstep(tst, b)
        for k in ("loss", "gnorm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=STEP_RTOL, err_msg=f"{k} {i}")
        for a, c in zip(jax.tree_util.tree_leaves(jst), tree_leaves(tst)):
            np.testing.assert_allclose(c.numpy(), np.asarray(a),
                                       err_msg=f"step {i}", **PARAM_TOL)


def test_engines_refuse_paging_and_pad_lens(model):
    (_, _), (tp, tcfg) = model
    assert not supports_paged_cache(tcfg)
    assert not supports_ragged_mask(tcfg)
    with pytest.raises(ValueError, match="cannot serve paged"):
        TEngine(tp, tcfg, device="cpu")
    with pytest.raises(ValueError, match="pad_lens"):
        generate(tp, tcfg, np.zeros((2, 4), np.int32), max_new=2,
                 pad_lens=[1, 0])

