"""Port parity for the xlstm family (xlstm-1.3b: mLSTM and sLSTM blocks, an
untied head) on the CPU against the JAX package: the config field for
field; ``nn/xlstm.py`` (the chunkwise mLSTM against the reference's and
against the exact step recurrence at chunks 8/16/64, rtol = atol = 2e-4
as ``tests/test_xlstm_ssm.py``; the carry composing across calls; the
sLSTM and both blocks, with and without a cache); and, reduced with one
sLSTM block (``slstm_every=2``: ``reduced()`` alone keeps 2 layers and
2 // 8 = 0 sLSTM blocks), the scanned layer order (and the reference's
scanned and unrolled orders parting where ``n_layers % slstm_every !=
0``), the dense cache, the static decode step leaving the xLSTM state
unwritten, and what the engines refuse.  Logits within 1e-4 of the
largest |logit|.  The model in fp (serving, gradients, training,
layouts) is held in ``tests/test_torch_xlstm_model.py``, with the exact
encoding in ``tests/test_torch_xlstm_serve.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import init_cache as j_cache  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models.registry import input_specs as j_specs  # noqa: E402
from repro.models.registry import runnable as j_runnable  # noqa: E402
from repro.nn import blocks as JB  # noqa: E402
from repro.nn import xlstm as JX  # noqa: E402

from repro_torch.configs import SHAPES, ModelConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import (apply_model, init_cache,  # noqa: E402
                                init_model, input_specs, layer_kinds,
                                params_from_jax, runnable,
                                supports_paged_cache, supports_ragged_mask)
from repro_torch.nn import blocks as TB  # noqa: E402
from repro_torch.nn import xlstm as TX  # noqa: E402
from repro_torch.serve import Engine as TEngine, generate  # noqa: E402
from repro_torch.serve.engine import (_commit_states, _states,  # noqa: E402
                                      _static_decode, make_decode_step,
                                      make_prefill)

ARCH = "xlstm-1.3b"
REC_TOL = dict(rtol=2e-4, atol=2e-4)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _t(tree):
    """A reference tree of jax arrays as torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, share=1e-4, err_msg=""):
    """Every element within ``share`` of the reference's largest |value|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    top = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= share * top, f"{err_msg}: {err} > {share} x {top}"


def _cfgs(**kw):
    return (dataclasses.replace(jget(ARCH).reduced(), **kw),
            dataclasses.replace(tget(ARCH).reduced(), **kw))


def _j_init(jcfg, seed=0):
    # jitted: a fraction of the eager init's compile time
    return jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)


def _tokens(S, B=2, seed=5):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


# --- config -------------------------------------------------------------------

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
    assert tget(ARCH).reduced().chunk_size == 32
    # a depth cut keeps a multiple of slstm_every (7 mLSTM + 1 sLSTM)
    cut = tget(ARCH).with_layers(8)
    assert layer_kinds(cut) == ["mlstm"] * 7 + ["slstm"]
    with pytest.raises(ValueError, match="slstm_every"):
        tget(ARCH).with_layers(4)


# --- nn/xlstm.py ----------------------------------------------------------------

def _rand_qkvif(seed, B=2, T=64, H=2, dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, H, dh)).astype(np.float32)
               for _ in range(3))
    ig = (rng.normal(size=(B, T, H)) - 1.0).astype(np.float32)
    fg = np.log(1 / (1 + np.exp(-rng.normal(size=(B, T, H)) - 3.0))
                ).astype(np.float32)
    return q, k, v, ig, fg


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunkwise_matches_reference_and_step(chunk):
    arrs = _rand_qkvif(0)
    jh, jc = JX.mlstm_chunkwise(*map(jnp.asarray, arrs), chunk=chunk)
    q, k, v, ig, fg = map(torch.from_numpy, arrs)
    th, tc = TX.mlstm_chunkwise(q, k, v, ig, fg, chunk=chunk)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **REC_TOL)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **REC_TOL)
    B, T, H, dh = q.shape
    st = TX.init_mlstm_state(B, H, dh, "cpu")
    hs = []
    for t in range(T):
        st, h = TX.mlstm_step(st, (q[:, t], k[:, t], v[:, t], ig[:, t],
                                   fg[:, t]))
        hs.append(h)
    np.testing.assert_allclose(th.numpy(), torch.stack(hs, 1).numpy(),
                               **REC_TOL)
    np.testing.assert_allclose(tc[0].numpy(), st[0].numpy(), **REC_TOL)
    np.testing.assert_allclose(tc[2].numpy(), st[2].numpy(), **TOL)


def test_mlstm_chunk_is_all_of_s_where_chunk_does_not_divide():
    """S = 40 at chunk 16: one chunk of 40, as the reference's
    ``L = S`` rule, not 16 + 16 + 8."""
    arrs = _rand_qkvif(2, T=40)
    jh, _ = JX.mlstm_chunkwise(*map(jnp.asarray, arrs), chunk=16)
    th, _ = TX.mlstm_chunkwise(*map(torch.from_numpy, arrs), chunk=16)
    one, _ = TX.mlstm_chunkwise(*map(torch.from_numpy, arrs), chunk=40)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **REC_TOL)
    assert torch.equal(th, one)


def test_mlstm_chunkwise_carry_composes():
    arrs = [torch.from_numpy(a) for a in _rand_qkvif(1)]
    h_full, _ = TX.mlstm_chunkwise(*arrs, chunk=16)
    h_a, c_a = TX.mlstm_chunkwise(*(a[:, :32] for a in arrs), chunk=16)
    h_b, _ = TX.mlstm_chunkwise(*(a[:, 32:] for a in arrs), carry=c_a,
                                chunk=16)
    np.testing.assert_allclose(h_full[:, 32:].numpy(), h_b.numpy(),
                               **REC_TOL)
    np.testing.assert_allclose(h_full[:, :32].numpy(), h_a.numpy(),
                               **REC_TOL)


def _block_case(kind, cached, S=12, seed=3):
    """One block of ``kind`` ('mlstm' / 'slstm') in both packages on the
    same input, with a fresh cache or none: (outputs, new caches)."""
    jcfg, tcfg = _cfgs()
    init = {"mlstm": JB.mlstm_block_init, "slstm": JB.slstm_block_init}
    apply_j = {"mlstm": JB.mlstm_block_apply, "slstm": JB.slstm_block_apply}
    apply_t = {"mlstm": TB.mlstm_block_apply, "slstm": TB.slstm_block_apply}
    jp = init[kind](jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).normal(size=(2, S, 128)).astype(
        np.float32)
    jc = tc = None
    if cached:
        mk = {"mlstm": (JX.init_mlstm_cache, TX.init_mlstm_cache),
              "slstm": (JX.init_slstm_cache, TX.init_slstm_cache)}[kind]
        jc = jax.tree_util.tree_map(lambda a: a[0], mk[0](jcfg, 2, 1))
        tc = mk[1](tcfg, 2, 1, device="cpu")[0]
        for k, t in tc.items():
            np.testing.assert_array_equal(t.numpy(), np.asarray(jc[k]))
    jo, jc2, _ = apply_j[kind](jp, jnp.asarray(x), jcfg, cache=jc)
    with torch.inference_mode():
        to, tc2, _ = apply_t[kind](_t(jp), torch.from_numpy(x), tcfg,
                                   cache=tc)
    return (to, jo), (tc2, jc2)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_match_reference(kind, cached):
    (to, jo), (tc, jc) = _block_case(kind, cached)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    if cached:
        assert sorted(tc) == sorted(jc)
        for k in tc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       err_msg=k, **REC_TOL)
    else:
        assert tc is None and jc is None


def test_mlstm_decode_continues_prefill():
    """A 12-token prefill into the cache, then 3 single-token steps
    (``mlstm_step``) and one 2-token call (chunkwise from the carry), in
    both packages: every output and the final state."""
    jcfg, tcfg = _cfgs()
    jp = JX.mlstm_init(jax.random.PRNGKey(4), jcfg)
    tp = _t(jp)
    rng = np.random.default_rng(4)
    jc = jax.tree_util.tree_map(lambda a: a[0],
                                JX.init_mlstm_cache(jcfg, 2, 1))
    tc = TX.init_mlstm_cache(tcfg, 2, 1, device="cpu")[0]
    for S in (12, 1, 1, 1, 2):
        x = rng.normal(size=(2, S, 128)).astype(np.float32)
        jo, jc = JX.mlstm_apply(jp, jnp.asarray(x), jcfg, cache=jc)
        with torch.inference_mode():
            to, tc = TX.mlstm_apply(tp, torch.from_numpy(x), tcfg, cache=tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    for k in tc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   err_msg=k, **REC_TOL)


# --- the model ----------------------------------------------------------------

def test_layer_order_is_the_scanned_one():
    """At (n_layers, slstm_every) = (4, 2) the port runs m s m s, the
    reference's scanned order; at (3, 2) the port runs the scanned order
    m m s too, while the reference's unrolled forward (``scan_layers=
    False``, the one its calibration uses) runs m s m: the two parts by
    far more than f32 order.  The port serves and trains in the scanned
    order."""
    toks = _tokens(12, seed=7)
    for n in (4, 3):
        jcfg, tcfg = _cfgs(slstm_every=2, n_layers=n)
        jp = _j_init(jcfg)
        scan, _, _ = j_apply(jp, jcfg, jnp.asarray(toks))
        with torch.inference_mode():
            tl, _ = apply_model(params_from_jax(_to_np(jp), tcfg, "cpu"),
                                tcfg, torch.from_numpy(toks))
        _close(tl.numpy(), scan, err_msg=f"n_layers={n}")
        want = ["mlstm", "mlstm", "slstm"] if n == 3 else \
            ["mlstm", "slstm"] * 2
        assert layer_kinds(tcfg) == want
    unrolled, _, _ = j_apply(jp, dataclasses.replace(jcfg, scan_layers=False),
                             jnp.asarray(toks))
    assert float(jnp.abs(scan - unrolled).max()) > 1e-1


def test_cache_layout_is_the_references():
    """Per layer the mLSTM's ``{C, n, m, conv}`` or the sLSTM's ``{h, c,
    m, n}``, in the reference's shapes, dtypes and initial values."""
    jcfg, tcfg = _cfgs(slstm_every=2, n_layers=4)
    jc = j_cache(jcfg, 3, 40)["layers"]["xlstm"]
    tc = init_cache(tcfg, 3, 40, device="cpu")
    subs = [next(iter(layer)) for layer in tc["layers"]]
    assert subs == ["mlstm", "slstm"] * 2
    seen = {"mlstm": 0, "slstm": 0}
    for layer, sub in zip(tc["layers"], subs):
        ref = jc[sub]
        assert sorted(layer[sub]) == sorted(ref)
        for k, t in layer[sub].items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(ref[k][seen[sub]]))
        seen[sub] += 1


def test_static_decode_leaves_the_xlstm_state_unwritten():
    """The static decode step returns the new mLSTM and sLSTM states and
    writes none: run twice from one cache it gives the same logits and
    states (a CUDA graph's warm-up and capture), and committing them
    moves the state."""
    _, cfg = _cfgs(slstm_every=2)
    params = init_model(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 2, 32, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        _, cache = make_prefill(cfg)(params, cache, toks)
        layers = [{k: {n: t.clone() for n, t in v.items()}
                   for k, v in layer.items()} for layer in cache["layers"]]
        before = [{k: v.clone() for k, v in s.items()}
                  for s in _states(layers)]
        assert len(before) == 2
        tok = torch.zeros((2, 1), dtype=torch.int32)
        pos = cache["pos"].clone()
        step = make_decode_step(cfg)
        a = _static_decode(step, params, layers, cfg.vocab_size, tok, pos)
        b = _static_decode(step, params, layers, cfg.vocab_size, tok, pos)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        for old, s in zip(before, _states(layers)):
            assert all(torch.equal(old[k], s[k]) for k in s)
        _commit_states(layers, a[3])
    for new, s in zip(a[3], _states(layers)):
        assert all(torch.equal(new[k], s[k]) for k in s)
    assert not torch.equal(before[1]["c"], _states(layers)[1]["c"])


def test_input_specs_and_runnable_match_reference():
    jc, tc = jget(ARCH), tget(ARCH)
    for name, shape in SHAPES.items():
        want = j_specs(jc, JSHAPES[name])
        got = input_specs(tc, shape)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} \
            == {k: (s, str(d).replace("torch.", ""))
                for k, (s, d) in got.items()}
        assert runnable(tc, shape) == j_runnable(jc, JSHAPES[name])


def test_engines_refuse_paging_and_pad_lens():
    """Recurrent state cannot page, and the pads it ingests cannot be
    masked: the continuous engine and ``pad_lens`` are refused, as in the
    reference."""
    _, tcfg = _cfgs(slstm_every=2)
    tp = init_model(tcfg, seed=0, device="cpu")
    assert not supports_paged_cache(tcfg)
    assert not supports_ragged_mask(tcfg)
    with pytest.raises(ValueError, match="cannot serve paged"):
        TEngine(tp, tcfg, device="cpu")
    with pytest.raises(ValueError, match="pad_lens"):
        generate(tp, tcfg, np.zeros((2, 4), np.int32), max_new=2,
                 pad_lens=[1, 0])
