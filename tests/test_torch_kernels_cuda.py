"""The hand-written CUDA kernels against their plain PyTorch versions on
the card.  This file imports neither JAX nor the JAX package, so it runs
on a machine with a card and torch alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Without a card the tests marked ``cuda`` skip; the ctypes bindings are
still checked against the C sources.  Tolerances: kernel 1 only sums in
another f32 order (rtol 1e-4, atol 1e-4·max|ref|); kernel 2 in f32 differs
by exp ULPs and summation order (rtol 1e-4, atol 1e-5; its int8/int4 pools
widen to the same f32 values in both, so the same tolerance holds), in
bf16 by one rounding of the output (atol 2e-2); kernel 3 (flash
attention) as the reference's tests/test_kernel_flash.py: 2e-4 in f32,
3e-2 in bf16."""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import circuits  # noqa: E402
from repro_torch.core.decompose import decompose  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import encoded_matmul as tem  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.quant.kvcache import quantize_kv  # noqa: E402


def _c_params(source: str, fn: str) -> list:
    """Parameter types of ``extern "C" int fn(...)`` in csrc/<source>.cu."""
    text = (build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
    assert m, f"{fn} not found in {source}.cu"
    return [re.sub(r"\s*\b\w+$", "", p.strip())
            for p in m.group(1).split(",")]


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("mod,source,fn", [
    (tem, "encoded_matmul", "encoded_matmul_launch"),
    (tpa, "paged_attention", "paged_attn_launch"),
    (tfa, "flash_attention", "flash_attention_launch")])
def test_ctypes_binding_matches_c_signature(mod, source, fn):
    """Every pointer (and the stream) is declared c_void_p, every int
    c_int, every float c_float, in the C signature's order."""
    params = _c_params(source, fn)
    want = tuple(ctypes.c_void_p if p.endswith("*") else _CTYPE[p]
                 for p in params)
    assert mod.ARGTYPES == want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _program(kind):
    if kind == "exact":
        c, _ = circuits.exact_product_circuit(8, 8)
    else:              # M = 48 with 3-bit activation monomials
        gt, ii = circuits.sample_circuits(np.random.default_rng(2), 1, 48)
        c = circuits.Circuit(gt[0], ii[0])
    return decompose(c)


def _em_args(kind, m, k, n, dev, seed=0):
    prog = _program(kind)
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wt = (rng.normal(size=(prog.n_a_planes, k, n)) * 4).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    return (torch.from_numpy(x).to(dev),
            torch.from_numpy(wt).to(torch.bfloat16).to(dev),
            torch.from_numpy(bias).to(dev), prog.a_mono_bits)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["exact", "sampled"])
@pytest.mark.parametrize("shape", [(4, 1024, 2816), (100, 130, 70)])
def test_encoded_matmul_kernel_matches_plain(cuda_device, kind, shape):
    args = _em_args(kind, *shape, cuda_device)
    before = tem.encoded_matmul.launches
    out = tem.encoded_matmul(*args)
    torch.cuda.synchronize()
    assert tem.encoded_matmul.launches == before + 1
    ref = tem.encoded_matmul_plain(*args)
    torch.testing.assert_close(out, ref, rtol=1e-4,
                               atol=1e-4 * ref.abs().max().item())


@pytest.mark.cuda
def test_encoded_matmul_kernel_refuses_f32_weights(cuda_device):
    """A CUDA tensor the kernel does not take raises; it never reaches
    the plain version."""
    x, wt, bias, shifts = _em_args("exact", 4, 64, 32, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tem.encoded_matmul(x, wt.float(), bias, shifts)


def _pa_args(dev, B, Hq, Hkv, D, ps, P, dtype, seed=3):
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * P
    pages = np.stack([1 + b * P + rng.permutation(P) for b in range(B)])
    g = max(1, Hq // Hkv)
    kv_map = np.minimum(np.arange(Hq) // g, Hkv - 1).astype(np.int32)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dtype).to(dev)
    return (t(B, 1, Hq, D), t(n_pages, ps, Hkv, D), t(n_pages, ps, Hkv, D),
            torch.from_numpy(pages.astype(np.int32)).to(dev)), kv_map


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv,window,cap,dtype", [
    (16, 16, None, None, "float32"),
    (8, 2, 20, 30.0, "float32"),
    (16, 16, None, None, "bfloat16")])
def test_paged_attn_kernel_matches_plain(cuda_device, Hq, Hkv, window, cap,
                                         dtype):
    ps, P, D = 16, 8, 64
    lens = np.asarray([0, 1, 15, 16, 17, P * ps - 1], np.int32)
    dt = getattr(torch, dtype)
    (q, pk, pv, pages), kv_map = _pa_args(cuda_device, len(lens), Hq, Hkv,
                                          D, ps, P, dt)
    args = (q, pk, pv, pages, torch.from_numpy(lens).to(cuda_device))
    before = tpa.paged_attn.launches
    out = tpa.paged_attn(*args, scale=D ** -0.5, window=window, cap=cap,
                         kv_of_q=kv_map)
    torch.cuda.synchronize()
    assert tpa.paged_attn.launches == before + 1
    ref = tpa.paged_attn_plain(*args, window or tpa._NO_WINDOW,
                               scale=D ** -0.5, cap=cap, G=Hq // Hkv)
    tol = (dict(rtol=1e-4, atol=1e-5) if dt == torch.float32
           else dict(rtol=0.0, atol=2e-2))
    torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert bool(torch.isfinite(out.float()).all())


def _quant_pools(dev, mode, n_pages, ps, Hkv, D, rng):
    """Random dense pools quantized on the CPU, moved to ``dev``."""
    out = []
    for _ in range(2):
        dense = torch.from_numpy(
            rng.normal(size=(n_pages, ps, Hkv, D)).astype(np.float32))
        q, s = quantize_kv(dense, mode)
        out += [q.to(dev), s.to(dev)]
    return out                                   # pk, sk, pv, sv


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("Sq,Hq,Hkv,window,cap", [
    (1, 16, 16, None, None),
    (1, 4, 2, 20, 30.0),
    (3, 4, 2, None, None)])
def test_paged_attn_kernel_quantized_matches_plain(cuda_device, mode, Sq, Hq,
                                                   Hkv, window, cap):
    ps, P, D = 16, 8, 64
    lens = np.asarray([0, 1, 15, 16, 17, P * ps - Sq], np.int32)
    rng = np.random.default_rng(Hq + Sq)
    B = len(lens)
    pk, sk, pv, sv = _quant_pools(cuda_device, mode, 1 + B * P, ps, Hkv, D,
                                  rng)
    pages = np.stack([1 + b * P + rng.permutation(P) for b in range(B)])
    q = torch.from_numpy(rng.normal(size=(B, Sq, Hq, D)).astype(
        np.float32)).to(cuda_device)
    args = (q, pk, pv, torch.from_numpy(pages.astype(np.int32)).to(
        cuda_device), torch.from_numpy(lens).to(cuda_device))
    kv_map = np.minimum(np.arange(Hq) // (Hq // Hkv), Hkv - 1)
    before = tpa.paged_attn.launches
    out = tpa.paged_attn(*args, scale=D ** -0.5, window=window, cap=cap,
                         kv_of_q=kv_map, scale_k=sk, scale_v=sv)
    torch.cuda.synchronize()
    assert tpa.paged_attn.launches == before + 1
    ref = tpa.paged_attn_plain(*args, window or tpa._NO_WINDOW,
                               scale=D ** -0.5, cap=cap, G=Hq // Hkv,
                               scale_k=sk, scale_v=sv)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_kv_on_the_card_matches_the_cpu(cuda_device, mode):
    """Codes and scales bit for bit: the card's tokens depend on it."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 33, 4, 64)).astype(np.float32) * 3)
    x[0] = 0.0
    q_c, s_c = quantize_kv(x, mode)
    q_g, s_g = quantize_kv(x.to(cuda_device), mode)
    assert torch.equal(q_g.cpu(), q_c)
    assert torch.equal(s_g.cpu(), s_c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,S,Hq,Hkv,D,window,cap", [
    ("float32", 2, 256, 4, 4, 64, None, None),
    ("float32", 1, 100, 4, 2, 32, 32, None),
    ("float32", 1, 192, 2, 1, 128, None, 20.0),
    ("bfloat16", 1, 100, 2, 2, 64, None, None),
    ("bfloat16", 2, 256, 4, 2, 64, 48, 30.0)])
def test_flash_kernel_matches_plain(cuda_device, dtype, B, S, Hq, Hkv, D,
                                    window, cap):
    rng = np.random.default_rng(S + D)
    dt = getattr(torch, dtype)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dt).to(cuda_device)
    q, k, v = t(B, S, Hq, D), t(B, S, Hkv, D), t(B, S, Hkv, D)
    kw = dict(scale=D ** -0.5, window=window, cap=cap, bq=64, bk=64)
    before = tfa.flash_attention.launches
    out = tops.flash_mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    G = Hq // Hkv
    flat = lambda x, H: tops._pad_to(  # noqa: E731
        x.permute(0, 2, 1, 3).reshape(B * H, S, D), 64, 1)
    ref = tfa.flash_attention_plain(flat(q, Hq), flat(k, Hkv), flat(v, Hkv),
                                    scale=D ** -0.5, window=window, cap=cap,
                                    bq=64, bk=64, G=G)
    ref = ref[:, :S].reshape(B, Hq, S, D).permute(0, 2, 1, 3)
    tol = 2e-4 if dt == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert bool(torch.isfinite(out.float()).all())
