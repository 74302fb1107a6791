"""Port parity for the three other dense-family archs, reduced
(qwen1.5-4b: untied LM head; starcoder2-3b: LayerNorm, non-gated GELU MLP
with biases, 2 KV heads; gemma2-27b: local/global windows, softcaps,
``attn_scale``, ``embed_scale``, post-norms): the configs field for field
and their per-layer windows, ``apply_model`` logits (rtol = atol = 1e-4),
and the greedy tokens of both of the port's engines against the
reference's, in fp and encoded-exact.  Prompts run past gemma2's reduced
window of 64, so the window masks keys."""
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
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa: E402
from repro.serve.engine import ServeEngine as JServe  # noqa: E402

from repro_torch.configs import ModelConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import apply_model as t_apply  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import (Engine as TEngine, ServeEngine as TServe,  # noqa: E402
                               exact_encodings, prepare_encoded_serving)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("qwen1.5-4b", "starcoder2-3b", "gemma2-27b")
MODES = ("fp", "encoded")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request, tmp_path_factory):
    """One arch's reduced reference params (fp, encoded-exact) and the
    port's: fp through the bridge, encoded both bridged (for logits) and
    calibrated and folded by the port itself (for serving)."""
    name = request.param
    jcfg = jget(name).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    override = {n: mac for n in ("wq", "wk", "wv", "wo", "wi", "wg", "w")}
    jpe, jce, _ = j_prepare(jp, jcfg, macs_override=override,
                            cache_dir=str(tmp_path_factory.mktemp("b")),
                            verbose=False)
    tcfg = tget(name).reduced()
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tp = params_from_jax(to_np(jp), tcfg, "cpu")
    tpe, tce, _ = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(), device="cpu",
        cache_dir=str(tmp_path_factory.mktemp("own")), verbose=False)
    return {"name": name,
            "fp": ((jp, jcfg), (tp, tcfg), tp),
            "encoded": ((jpe, jce), (tpe, tce),
                        params_from_jax(to_np(jpe), tcfg, "cpu"))}


def _fields(cfg, names):
    return {n: getattr(cfg, n) for n in names}


def test_config_matches_reference(arch):
    name = arch["name"]
    # the port names the paged backends 'gather'/'kernel' for the
    # reference's 'xla'/'pallas'
    names = [f.name for f in dataclasses.fields(ModelConfig)
             if f.name not in ("mac", "attention_backend")]
    for reduce in (False, True):
        j, t = jget(name), tget(name)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert _fields(t, names) == _fields(j, names), (name, reduce)
        assert (t.attention_backend, j.attention_backend) == ("gather", "xla")
        assert t.layer_windows == j.layer_windows
        assert (t.head_dim_r, t.n_heads_p, t.n_kv_p, t.vocab_p) == \
            (j.head_dim_r, j.n_heads_p, j.n_kv_p, j.vocab_p)
    red = tget(name).reduced()
    if name == "gemma2-27b":
        assert red.layer_windows == [64, None]      # local on even layers
        assert tget(name).layer_windows[:4] == [4096, None, 4096, None]
    else:
        assert red.layer_windows == [None, None]
    assert red.n_kv_heads == 2 and red.n_heads == 4


def _tokens(S):
    return np.random.default_rng(5).integers(0, 512, (2, S)).astype(np.int32)


@pytest.mark.parametrize("mode", MODES)
def test_logits_match_reference(arch, mode):
    (jp, jcfg), (_, tcfg), bridged = arch[mode]
    toks = _tokens(90)
    jl, _, _ = j_apply(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = t_apply(bridged, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def _trace():
    rng = np.random.default_rng(6)
    return [rng.integers(0, 512, n).astype(np.int32) for n in (70, 17, 90)]


@pytest.mark.parametrize("mode", MODES)
def test_both_engines_match_reference_tokens(arch, mode):
    """The reference's static engine over a ragged trace (left-padded,
    pads masked) gives the tokens; the port's static engine and its
    continuous engine (fused paged op's plain version) must give them."""
    (jp, jcfg), (tp, tcfg), _ = arch[mode]
    trace = _trace()
    want = [np.asarray(w) for w in
            JServe(jp, jcfg, batch_slots=2).run(trace, max_new=6)]
    got = TServe(tp, tcfg, batch_slots=2, device="cpu").run(trace,
                                                           max_new=6)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"static {i}")
    eng = TEngine(tp, dataclasses.replace(tcfg, attention_backend="kernel"),
                  device="cpu", n_slots=2, page_size=8, n_pages=64,
                  prefill_chunk=32)
    rids = [eng.submit(p, max_new=6) for p in trace]
    outs = eng.run()
    for i, rid in enumerate(rids):
        np.testing.assert_array_equal(outs[rid], want[i],
                                      err_msg=f"continuous {i}")
