"""Port parity for the flash-attention kernel's entry ``ops.flash_mha``:
its plain version (the path CPU tensors take) against the reference's
``flash_mha`` with the Pallas kernel in interpret mode, at the reference's
cases and tolerances (tests/test_kernel_flash.py: 2e-4; bf16 3e-2).  Also
pins the model path: the reference's ``cfg.flash_attention`` gate never
reaches its flash kernel, and the port's attention does not either."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.kernels.ops as jops  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402

import repro_torch.kernels.flash_attention as tfa  # noqa: E402
import repro_torch.kernels.ops as tops  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import apply_model as t_apply  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402


def _qkv(seed, B, S, Hq, Hkv, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, S, h, D)).astype(np.float32).astype(
        dtype) for h in (Hq, Hkv, Hkv))


def _both(q, k, v, **kw):
    t = lambda a: (torch.from_numpy(a.view(np.uint16)).view(  # noqa: E731
        torch.bfloat16) if a.dtype == ml_dtypes.bfloat16
        else torch.from_numpy(a))
    out = tops.flash_mha(t(q), t(k), t(v), **kw)
    ref = jops.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         backend="pallas_interpret", **kw)
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("S,D,bq,bk", [(128, 64, 64, 64), (192, 32, 64, 64),
                                       (256, 64, 128, 64)])
def test_flash_mha_matches_reference(S, D, bq, bk):
    q, k, v = _qkv(0, 2, S, 3, 3, D)
    out, ref = _both(q, k, v, scale=1 / np.sqrt(D), bq=bq, bk=bk)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("window,cap", [(32, None), (32, 20.0)])
def test_flash_mha_gqa_window_softcap(window, cap):
    q, k, v = _qkv(1, 1, 128, 4, 2, 32)
    out, ref = _both(q, k, v, scale=0.2, window=window, cap=cap, bq=64,
                     bk=64)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cap", [None, 30.0])
def test_flash_mha_bf16_padding(cap):
    """S = 100 pads to the 64-row blocks; p rounds to bf16 before P·V."""
    q, k, v = _qkv(2, 1, 100, 2, 2, 64, ml_dtypes.bfloat16)
    out, ref = _both(q, k, v, scale=0.125, cap=cap, bq=64, bk=64)
    assert out.shape == (1, 100, 2, 64)
    np.testing.assert_allclose(out, ref, rtol=3e-2, atol=3e-2)


def test_flash_mha_default_blocks_and_noncausal():
    q, k, v = _qkv(3, 1, 256, 2, 1, 64)
    out, ref = _both(q, k, v, scale=0.125)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    out, ref = _both(q, k, v, scale=0.125, causal=False, bq=64, bk=64)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_noncausal_padding_refused_as_in_reference():
    q, k, v = _qkv(4, 1, 100, 2, 2, 32)
    with pytest.raises(ValueError, match="non-causal padding"):
        jops.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       scale=0.2, causal=False, bq=64, bk=64,
                       backend="pallas_interpret")
    with pytest.raises(ValueError, match="non-causal padding"):
        tops.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), scale=0.2, causal=False, bq=64,
                       bk=64)


def test_cpu_tensors_never_count_as_launches():
    q, k, v = _qkv(5, 1, 64, 2, 2, 16)
    before = tfa.flash_attention.launches
    tops.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), scale=0.25, bq=64, bk=64)
    assert tfa.flash_attention.launches == before


@pytest.mark.parametrize("scan_layers", [True, False])
def test_flash_flag_stays_off_the_model_path(monkeypatch, scan_layers):
    """The reference's gate (nn/attention.py:110-111) needs a None or int
    window, but its model hands every layer an array: flash_mha is called
    0 times.  The port mirrors it: no call, and the reference's logits."""
    calls = {"ref": 0, "port": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jops, "flash_mha", spy("ref", jops.flash_mha))
    monkeypatch.setattr(tops, "flash_mha", spy("port", tops.flash_mha))
    monkeypatch.setattr(tfa, "flash_attention",
                        spy("port", tfa.flash_attention))
    jcfg = dataclasses.replace(jget("qwen1.5-0.5b").reduced(), n_layers=1,
                               attn_chunk=32, flash_attention=True,
                               scan_layers=scan_layers)
    params = j_init(jax.random.PRNGKey(0), jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             (1, 64)).astype(np.int32)
    jl, _, _ = j_apply(params, jcfg, jnp.asarray(toks))
    tcfg = dataclasses.replace(tget("qwen1.5-0.5b").reduced(), n_layers=1,
                               attn_chunk=32, flash_attention=True)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg,
                         "cpu")
    with torch.inference_mode():
        tl, _ = t_apply(tp, tcfg, torch.from_numpy(toks))
    assert calls == {"ref": 0, "port": 0}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
