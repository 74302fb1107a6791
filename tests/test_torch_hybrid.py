"""Port parity for the hybrid family's own modules on the CPU (reduced
hymba-1.5b): ``nn/ssm.py`` against ``repro.nn.ssm`` (the params' shapes
and dtypes, the selective scan against the reference's chunked scan and
its stepwise recurrence, the full path with and without a cache, decode
continuing a prefill), ``hybrid_block_apply`` against the reference's,
the dense cache of a hybrid arch, the static decode step leaving the SSM
state unwritten (so a CUDA graph's warm-up changes nothing), and
``supports_paged_cache`` refusing meta tokens as the reference does.
Tolerances: rtol = atol = 1e-4 (5e-4 for a decode against the whole
prefill, the reference's own)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import init_cache as j_cache  # noqa: E402
from repro.models import supports_paged_cache as j_pages  # noqa: E402
from repro.nn import blocks as JB  # noqa: E402
from repro.nn import ssm as JS  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import init_cache, supports_paged_cache  # noqa: E402
from repro_torch.models import init_model, supports_ragged_mask  # noqa: E402
from repro_torch.nn import blocks as TB  # noqa: E402
from repro_torch.nn import ssm as TS  # noqa: E402
from repro_torch.serve.engine import (_commit_states, _states,  # noqa: E402
                                      _static_decode, make_decode_step,
                                      make_prefill)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "hymba-1.5b"


def _t(tree):
    """A reference tree of jax arrays as torch tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = JS.ssm_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _t(jp)


def test_ssm_params_are_the_references():
    """Leaf names, shapes and dtypes as the reference's ``ssm_init``,
    ``dt_bias``/``a_log``/``dskip`` f32 under bf16 params too."""
    for pdt in ("float32", "bfloat16"):
        jc = dataclasses.replace(jget(ARCH).reduced(), param_dtype=pdt)
        tc = dataclasses.replace(tget(ARCH).reduced(), param_dtype=pdt)
        jp = JS.ssm_init(jax.random.PRNGKey(0), jc)
        tp = TS.ssm_init(torch.Generator().manual_seed(0), tc)
        assert sorted(tp) == sorted(jp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, k
            assert str(tp[k].dtype).replace("torch.", "") == \
                str(jp[k].dtype), k
        for k in ("dt_bias", "a_log", "dskip"):
            assert tp[k].dtype == torch.float32
        np.testing.assert_allclose(tp["a_log"].numpy(),
                                   np.asarray(jp["a_log"]), rtol=1e-6)


@pytest.mark.parametrize("T", [1, 8, 32])
def test_ssm_scan_matches_reference_and_stepwise(setup, T):
    """The port's one-loop scan against the reference's chunked scan and
    against its stepwise recurrence from ``_ssm_params``."""
    jcfg, tcfg, jp, tp = setup
    B, di = 2, jcfg.ssm_expand * jcfg.d_model
    xc = np.random.default_rng(0).normal(size=(B, T, di)).astype(np.float32)
    y_chunk, h_chunk = JS.ssm_scan(jp, jnp.asarray(xc), jcfg,
                                   chunk=8 if T >= 8 else T)
    dA, dBx, Cm = JS._ssm_params(jp, jnp.asarray(xc), jcfg)
    h = jnp.zeros((B, di, jcfg.ssm_state))
    ys = []
    for t in range(T):
        h = dA[:, t] * h + dBx[:, t]
        ys.append(jnp.einsum("bdn,bn->bd", h, Cm[:, t]))
    y_step = jnp.stack(ys, 1) + jnp.asarray(xc) * jp["dskip"]
    y, hf = TS.ssm_scan(tp, torch.from_numpy(xc), tcfg)
    for want in (y_chunk, y_step):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    for want in (h_chunk, h):
        np.testing.assert_allclose(hf.numpy(), np.asarray(want), **TOL)


def _zeros_cache(cfg, B):
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": np.zeros((B, cfg.ssm_conv - 1, di), np.float32),
            "h": np.zeros((B, di, cfg.ssm_state), np.float32)}


def test_ssm_apply_matches_reference(setup):
    """Without a cache; then a 12-token prefill into a cache and 4 decode
    steps: outputs and the new conv buffer and state at every call."""
    jcfg, tcfg, jp, tp = setup
    x = np.random.default_rng(1).normal(size=(2, 16, jcfg.d_model)).astype(
        np.float32)
    jo, _ = JS.ssm_apply(jp, jnp.asarray(x), jcfg)
    to, tc = TS.ssm_apply(tp, torch.from_numpy(x), tcfg)
    assert tc is None
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    zc = _zeros_cache(jcfg, 2)
    jc = {k: jnp.asarray(v) for k, v in zc.items()}
    tc = {k: torch.from_numpy(v) for k, v in zc.items()}
    for a, b in ((0, 12), (12, 13), (13, 14), (14, 15), (15, 16)):
        jo, jc = JS.ssm_apply(jp, jnp.asarray(x[:, a:b]), jcfg, cache=jc)
        to, tc2 = TS.ssm_apply(tp, torch.from_numpy(x[:, a:b]), tcfg,
                               cache=tc)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                                   err_msg=f"[{a}, {b})", **TOL)
        for k in ("conv", "h"):
            np.testing.assert_allclose(tc2[k].numpy(), np.asarray(jc[k]),
                                       err_msg=k, **TOL)
        # the old cache is not written: a step may run twice from it
        assert all(torch.equal(tc[k], torch.from_numpy(zc[k]))
                   for k in tc) or a > 0
        tc = tc2


def test_ssm_decode_continues_prefill(setup):
    """Token by token from an empty cache gives the cacheless pass."""
    _, tcfg, _, tp = setup
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 12, tcfg.d_model)).astype(np.float32))
    full, _ = TS.ssm_apply(tp, x, tcfg)
    cache = {k: torch.from_numpy(v) for k, v in _zeros_cache(tcfg,
                                                             1).items()}
    outs = []
    for t in range(12):
        o, cache = TS.ssm_apply(tp, x[:, t:t + 1], tcfg, cache=cache)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("window", [None, 4])
def test_hybrid_block_matches_reference(window):
    """``hybrid_block_apply`` without a cache (attention ∥ SSM on ln1,
    the normed mix, the MLP), global and windowed; aux 0."""
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = JB.hybrid_block_init(jax.random.PRNGKey(3), jcfg)
    tp = _t(jp)
    x = np.random.default_rng(4).normal(size=(2, 20, jcfg.d_model)).astype(
        np.float32)
    jo, _, ja = JB.hybrid_block_apply(
        jp, jnp.asarray(x), jcfg,
        window=None if window is None else jnp.int32(window))
    to, tc, ta = TB.hybrid_block_apply(tp, torch.from_numpy(x), tcfg,
                                       window=window)
    assert tc is None and float(ta) == float(ja) == 0.0
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_hybrid_cache_layout_is_the_references():
    """Attention rows for ``max_len + meta_tokens`` and the SSM state, per
    layer (the reference stacks them ``(L, …)``)."""
    jcfg, tcfg = jget(ARCH).reduced(), tget(ARCH).reduced()
    jc = j_cache(jcfg, 3, 40)["layers"]["stack"]
    tc = init_cache(tcfg, 3, 40, device="cpu")
    assert int(tc["pos"]) == 0 and len(tc["layers"]) == tcfg.n_layers
    for layer in tc["layers"]:
        assert sorted(layer) == sorted(jc) == ["attn", "ssm"]
        for sub in ("attn", "ssm"):
            assert sorted(layer[sub]) == sorted(jc[sub])
            for k, t in layer[sub].items():
                assert tuple(t.shape) == jc[sub][k].shape[1:], (sub, k)
    assert tc["layers"][0]["attn"]["k"].shape[1] == 40 + tcfg.meta_tokens


def test_static_decode_leaves_the_ssm_state_unwritten():
    """The static decode step returns the new SSM states and writes none:
    run twice from one cache it gives the same logits and states (a
    graph's warm-up and capture), and committing them moves the state."""
    cfg = tget(ARCH).reduced()
    params = init_model(cfg, seed=0, device="cpu")
    cache = init_cache(cfg, 2, 32, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        _, cache = make_prefill(cfg)(params, cache, toks)
        layers = [{"attn": layer["attn"],
                   "ssm": {k: v.clone() for k, v in layer["ssm"].items()}}
                  for layer in cache["layers"]]
        before = [{k: v.clone() for k, v in s.items()}
                  for s in _states(layers)]
        tok = torch.zeros((2, 1), dtype=torch.int32)
        pos = cache["pos"].clone()
        step = make_decode_step(cfg)
        a = _static_decode(step, params, layers, cfg.vocab_size, tok, pos)
        b = _static_decode(step, params, layers, cfg.vocab_size, tok, pos)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for old, s in zip(before, _states(layers)):
        assert all(torch.equal(old[k], s[k]) for k in s)
    with torch.inference_mode():
        _commit_states(layers, a[3])
    for new, s in zip(a[3], _states(layers)):
        assert all(torch.equal(new[k], s[k]) for k in s)
    assert not torch.equal(before[0]["h"], _states(layers)[0]["h"])


def test_paging_needs_no_meta_tokens():
    """``supports_paged_cache`` as the reference's: recurrent state or
    meta tokens refuse paging (and with it ragged-pad masking), on any
    family."""
    for name in ("qwen1.5-0.5b", "qwen3-moe-235b-a22b", ARCH,
                 "phi-3-vision-4.2b", "deepseek-v3-671b"):
        for meta in (0, 4):
            jc = dataclasses.replace(jget(name).reduced(), meta_tokens=meta)
            tc = dataclasses.replace(tget(name).reduced(), meta_tokens=meta)
            assert supports_paged_cache(tc) == j_pages(jc), (name, meta)
            if meta:
                assert not supports_paged_cache(tc)
                assert not supports_ragged_mask(tc)
