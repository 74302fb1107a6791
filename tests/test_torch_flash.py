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
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

import repro.kernels.flash_attention as jflash  # noqa: E402
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


@pytest.mark.parametrize("dtype,D,route", [
    ("bfloat16", 16, "mma"), ("bfloat16", 32, "mma"), ("bfloat16", 48, "mma"),
    ("bfloat16", 64, "mma"), ("bfloat16", 128, "mma"),
    ("bfloat16", 8, "fma"), ("bfloat16", 40, "fma"), ("bfloat16", 100, "fma"),
    ("float32", 64, "tf32x3"), ("float32", 128, "tf32x3"),
    ("float16", 64, "fma")])
def test_flash_route_by_dtype_and_head_dim(dtype, D, route):
    """bf16 with D a multiple of 16 up to 128 takes the bf16 tensor-core
    kernel; f32 with D a multiple of 8 up to 128 the 3xTF32 tensor-core
    kernel; bf16 and f32 with any other D, and other dtypes, the FMA
    kernel."""
    assert tfa.flash_route(getattr(torch, dtype), D) == route


@pytest.mark.parametrize("D,route", [
    (8, "tf32x3"), (32, "tf32x3"), (40, "tf32x3"), (120, "tf32x3"),
    (4, "fma"), (12, "fma"), (36, "fma"), (100, "fma"), (136, "fma")])
def test_flash_route_f32_keeps_fma_off_the_tf32_dims(D, route):
    """f32 head dims that are not a multiple of 8 (or above 128) keep the
    FMA kernel."""
    assert tfa.flash_route(torch.float32, D) == route


# ---------------------------------------------------------------------------
# the 3xTF32 route's arithmetic, emulated in torch
# ---------------------------------------------------------------------------

def _rna_bits(x):
    """cvt.rna.tf32.f32 by hand on numpy f32: round the 13 low bits of the
    magnitude to nearest, ties away from zero."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def test_split_tf32_is_rna_and_nearly_exact():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4096) * 10.0 ** rng.integers(
        -6, 6, 4096), [0.0, -0.0, 1.0, -1.5, 3.0e-38, 1.0 + 2 ** -11,
                       1.0 + 2 ** -12, -(1.0 + 2 ** -11)]]).astype(np.float32)
    hi, lo = tfa.split_tf32(torch.from_numpy(x))
    hi, lo = hi.numpy(), lo.numpy()
    for part in (hi, lo):                   # tf32: the low 13 bits are 0
        assert not (part.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi, _rna_bits(x))
    np.testing.assert_array_equal(lo, _rna_bits(x - hi))
    # ties go away from zero: 1 + 2^-11 lies halfway between tf32 values
    assert hi[-3] == np.float32(1.0 + 2 ** -10)
    assert hi[-1] == np.float32(-(1.0 + 2 ** -10))
    big = np.abs(x) > 1e-30
    assert np.all(np.abs(hi + lo - x)[big] <= 2.0 ** -21 * np.abs(x)[big])


def _mm3(a, b):
    """a @ b in 3xTF32: lo·hi + hi·lo + hi·hi into one f32 sum, small
    terms first; each product of two tf32 values is exact in f32."""
    ah, al = tfa.split_tf32(a)
    bh, bl = tfa.split_tf32(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def flash_tf32x3(q, k, v, *, scale, causal=True, window=None, cap=None,
                 G=1, bq=64, bk=64):
    """``flash_attention_plain``'s recurrence with both products in
    3xTF32, p kept in f32 (v is f32), as the kernel's ``"tf32x3"`` route
    computes."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    if G > 1:
        k = k.repeat_interleave(G, dim=0)
        v = v.repeat_interleave(G, dim=0)
    neg = torch.tensor(tfa.NEG_INF)
    out = torch.empty_like(q)
    for i in range(Sq // bq):
        qt = q[:, i * bq:(i + 1) * bq]
        m = torch.full((BH, bq, 1), tfa.NEG_INF)
        l = torch.zeros((BH, bq, 1))
        acc = torch.zeros((BH, bq, D))
        q_pos = i * bq + torch.arange(bq)[:, None]
        for j in range(Sk // bk):
            s = _mm3(qt, k[:, j * bk:(j + 1) * bk].transpose(1, 2)) * scale
            s = tfa._softcap(s, cap)
            k_pos = j * bk + torch.arange(bk)[None, :]
            ok = torch.ones((bq, bk), dtype=torch.bool)
            if causal:
                ok = ok & (q_pos >= k_pos)
            if window is not None:
                ok = ok & ((q_pos - k_pos) < window)
            s = torch.where(ok, s, neg)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + _mm3(p, v[:, j * bk:(j + 1) * bk])
            m = m_new
        out[:, i * bq:(i + 1) * bq] = acc / torch.clamp_min(l, 1e-30)
    return out


@pytest.mark.parametrize("BH,G,S,D,window,cap", [
    (4, 1, 128, 64, None, None),     # the prefill shape's head dim
    (4, 2, 192, 32, None, None),     # GQA
    (2, 1, 128, 128, 48, 20.0),      # window + softcap, D 128
    (2, 2, 64, 8, None, 30.0)])
def test_tf32x3_recurrence_matches_plain_and_reference(BH, G, S, D, window,
                                                        cap):
    """Within 1e-5 of the f32 plain version (the card's gate at the
    prefill shape) and within the reference's 2e-4 of its Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(S + D)
    q, k, v = (rng.normal(size=(n, S, D)).astype(np.float32)
               for n in (BH, BH // G, BH // G))
    kw = dict(scale=D ** -0.5, window=window, cap=cap)
    t = torch.from_numpy
    emu = flash_tf32x3(t(q), t(k), t(v), G=G, **kw)
    plain = tfa.flash_attention_plain(t(q), t(k), t(v), G=G, bq=64, bk=64,
                                      **kw)
    assert float((emu - plain).abs().max()) <= 1e-5
    ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(np.repeat(
        k, G, 0)), jnp.asarray(np.repeat(v, G, 0)), bq=64, bk=64,
        interpret=True, **kw)
    np.testing.assert_allclose(emu.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-4)


def test_p_fragment_key_permutation():
    """P.V with P's m16n8k8 A fragment taken from the S accumulator in
    place (k-slot t = key 2t, slot t + 4 = key 2t + 1) and V's B fragment
    rows 2t, 2t + 1 computes P.V: the fragments, written out for the 32
    lanes of a warp (g = lane / 4, t = lane % 4), multiply to the same
    16 x 8 product as the unpermuted matrices."""
    rng = np.random.default_rng(1)
    P = rng.normal(size=(16, 8))
    V = rng.normal(size=(8, 8))
    A = np.full((16, 8), np.nan)             # A[row, k-slot]
    Bm = np.full((8, 8), np.nan)             # B[k-slot, col]
    for lane in range(32):
        g, t = lane // 4, lane % 4
        # S accumulator: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
        c = {0: P[g, 2 * t], 1: P[g, 2 * t + 1], 2: P[g + 8, 2 * t],
             3: P[g + 8, 2 * t + 1]}
        # A fragment: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = (
            c[0], c[2], c[1], c[3])
        # B fragment: b0 (k t, n g), b1 (k t+4, n g): V rows 2t, 2t + 1
        Bm[t, g], Bm[t + 4, g] = V[2 * t, g], V[2 * t + 1, g]
        for slot in (t, t + 4):
            assert A[g, slot] == P[g, tfa.P_KEY_OF_SLOT[slot]]
            assert Bm[slot, g] == V[tfa.P_KEY_OF_SLOT[slot], g]
    assert not np.isnan(A).any() and not np.isnan(Bm).any()
    assert sorted(tfa.P_KEY_OF_SLOT) == list(range(8))
    np.testing.assert_allclose(A @ Bm, P @ V, rtol=1e-12, atol=1e-12)


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
