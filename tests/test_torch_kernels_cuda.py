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
import functools
import itertools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.core import circuits  # noqa: E402
from repro_torch.core.decompose import decompose  # noqa: E402
from repro_torch.core import gates  # noqa: E402
from repro_torch.core.encoding import (EncodingSpec,  # noqa: E402
                                       fit_position_weights)
from repro_torch.core.search import anneal, random_search  # noqa: E402
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


def test_ctypes_binding_of_the_launch_floor():
    """The empty kernel that times kernel 2's launch floor, likewise."""
    params = _c_params("paged_attention", "paged_attn_floor_launch")
    assert tpa.FLOOR_ARGTYPES == tuple(
        ctypes.c_void_p if p.endswith("*") else _CTYPE[p] for p in params)


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


@functools.lru_cache(maxsize=None)
def _searched_shifts():
    """The monomials of a circuit searched on the card at the serving
    CLI's defaults (M = 48, 128 samples, 64 anneal steps)."""
    res = random_search(0, 48, 128, patience=128, device="cuda")
    res = anneal(res.spec, 7919, 64, device="cuda")
    return decompose(res.spec.circuit).a_mono_bits


def _shifts(kind, rng):
    """(U, 3) monomial shifts: a program's, every 1-3-bit monomial of 8
    bits (U = 92, the most a program can have), a searched program's, or
    48 random 1-3-bit ones."""
    if kind == "full92":
        monos = [list(m) for r in (1, 2, 3)
                 for m in itertools.combinations(range(8), r)]
        return np.asarray([(m + m[-1:] * 3)[:3] for m in monos], np.int32)
    if kind == "searched":
        return _searched_shifts()
    if kind != "random48":
        return _program(kind).a_mono_bits
    bits = [sorted(rng.choice(8, rng.integers(1, 4), replace=False))
            for _ in range(48)]
    return np.asarray([(b + b[-1:] * 3)[:3] for b in bits], np.int32)


def _em_args(kind, m, k, n, dev, seed=0):
    rng = np.random.default_rng(seed)
    shifts = _shifts(kind, rng)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wt = (rng.normal(size=(len(shifts), k, n)) * 4).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    return (torch.from_numpy(x).to(dev),
            torch.from_numpy(wt).to(torch.bfloat16).to(dev),
            torch.from_numpy(bias).to(dev), shifts)


# the main path's linears at decode (m = 4 slots), prefill (m = one
# 32-token chunk) and speculative verification (m = 4·(k+1): 20 at k = 4,
# 36 at k = 8), then ragged m, k and n
EM_SHAPES = [(m, k, n) for m in (4, 32, 20, 36)
             for k, n in ((1024, 1024), (1024, 2816), (2816, 1024))]
EM_SHAPES += [(1, 130, 70), (33, 1024, 70), (100, 130, 70),
              (100, 2816, 1024), (1, 2816, 2816), (33, 130, 2816)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["exact", "sampled", "random48", "full92",
                                  "searched"])
@pytest.mark.parametrize("shape", EM_SHAPES)
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
@pytest.mark.parametrize("weighted", [False, True])
def test_fit_on_the_card_matches_the_cpu(cuda_device, weighted):
    """The least-squares fit on the card against the CPU: RMSE within rtol
    1e-5, LUTs (B·s, which is unique where s is not) within 1e-4·max|v|."""
    rng = np.random.default_rng(4)
    gt, ii = circuits.sample_circuits(rng, 40, 48)
    vals = gates.signed_products(8, 8)
    w = rng.random(65536).astype(np.float32) * 2 if weighted else None
    s_g, r_g = fit_position_weights(gt, ii, vals, row_weights=w,
                                    device=cuda_device)
    s_c, r_c = fit_position_weights(gt, ii, vals, row_weights=w,
                                    device="cpu")
    np.testing.assert_allclose(r_g, r_c, rtol=1e-5)
    for i in range(len(gt)):
        spec = EncodingSpec(circuits.circuit_from_batch(gt, ii, i), s_c[i],
                            float(r_c[i]))
        np.testing.assert_allclose(spec.lut(s_g[i]).numpy(),
                                   spec.lut().numpy(), rtol=0,
                                   atol=1e-4 * np.abs(vals).max())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_on_the_card_picks_the_cpu_circuits(cuda_device, seed):
    res = {}
    for dev in (cuda_device, "cpu"):
        r = random_search(seed, 48, 64, patience=64, device=dev)
        res[str(dev)] = anneal(r.spec, seed + 7919, 32, batch=16,
                               device=dev)
    g, c = res[str(cuda_device)], res["cpu"]
    np.testing.assert_array_equal(g.spec.circuit.gate_types,
                                  c.spec.circuit.gate_types)
    np.testing.assert_array_equal(g.spec.circuit.in_idx,
                                  c.spec.circuit.in_idx)
    np.testing.assert_allclose(g.rmse_trace, c.rmse_trace, rtol=1e-5)


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
@pytest.mark.parametrize("Hq,Hkv,window,cap,dtype,P", [
    (16, 16, None, None, "float32", 8),
    (8, 2, 20, 30.0, "float32", 8),
    (16, 16, None, None, "bfloat16", 8),
    # the serve's 127-page table: idle rows and a row filling the table
    (16, 16, None, None, "float32", 127),
    (16, 16, None, None, "bfloat16", 127),
    (4, 2, 50, 30.0, "float32", 127)])
def test_paged_attn_kernel_matches_plain(cuda_device, Hq, Hkv, window, cap,
                                         dtype, P):
    ps, D = 16, 64
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
@pytest.mark.parametrize("Sq,Hq,Hkv,window,cap,P", [
    (1, 16, 16, None, None, 8),
    (1, 4, 2, 20, 30.0, 8),
    (3, 4, 2, None, None, 8),
    (1, 16, 16, None, None, 127)])
def test_paged_attn_kernel_quantized_matches_plain(cuda_device, mode, Sq, Hq,
                                                   Hkv, window, cap, P):
    ps, D = 16, 64
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
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_paged_attn_is_one_kernel_on_a_fixed_grid(cuda_device, mode):
    """One CUDA kernel per call (no combine pass), whatever the table's
    width; the launch floor runs too.  The reduced config's head dim 32
    with GQA, as the card-against-CPU token check serves it."""
    from repro_torch.launch.kernel_bench import cuda_kernels_of
    ps, D, Hq, Hkv = 16, 32, 4, 2
    rng = np.random.default_rng(7)
    for P in (32, 127):
        lens = np.asarray([0, 5, 200, P * ps - 1], np.int32)
        B = len(lens)
        q = torch.from_numpy(rng.normal(size=(B, 1, Hq, D)).astype(
            np.float32)).to(cuda_device)
        kw = {}
        if mode == "bf16":
            pk, pv = (torch.from_numpy(rng.normal(size=(
                1 + B * P, ps, Hkv, D)).astype(np.float32)).to(cuda_device)
                for _ in range(2))
        else:
            pk, sk, pv, sv = _quant_pools(cuda_device, mode, 1 + B * P, ps,
                                          Hkv, D, rng)
            kw = dict(scale_k=sk, scale_v=sv)
        pages = torch.from_numpy(np.stack(
            [1 + b * P + rng.permutation(P) for b in range(B)]).astype(
                np.int32)).to(cuda_device)
        args = (q, pk, pv, pages, torch.from_numpy(lens).to(cuda_device))
        tpa.paged_attn(*args, scale=D ** -0.5, **kw)
        torch.cuda.synchronize()
        kernels = cuda_kernels_of(
            lambda: tpa.paged_attn(*args, scale=D ** -0.5, **kw))
        assert len(kernels) == 1 and "paged_attn" in kernels[0], kernels
        out = tpa.paged_attn(*args, scale=D ** -0.5, **kw)
        ref = tpa.paged_attn_plain(*args, tpa._NO_WINDOW, scale=D ** -0.5,
                                   G=Hq // Hkv, **kw)
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)
        tpa.paged_attn_floor(B, Hkv, P, cuda_device)
        torch.cuda.synchronize()


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
    # the 3xTF32 kernel: D 8, 40 and 128, S not a multiple of 64, GQA,
    # window + softcap; f32 with D 36 keeps the FMA kernel
    ("float32", 2, 100, 4, 4, 8, None, None),
    ("float32", 1, 130, 4, 1, 40, 70, 20.0),
    ("float32", 1, 300, 8, 2, 128, None, None),
    ("float32", 1, 100, 2, 2, 36, None, None),
    ("bfloat16", 1, 100, 2, 2, 64, None, None),
    ("bfloat16", 2, 256, 4, 2, 64, 48, 30.0),
    # the tensor-core kernel: D 32, 48, 64, 128, S not a multiple of 64,
    # GQA, window + softcap, and the prefill shape of qwen1.5-0.5b
    ("bfloat16", 2, 100, 4, 4, 32, None, None),
    ("bfloat16", 1, 130, 2, 1, 48, None, None),
    ("bfloat16", 1, 200, 8, 2, 128, None, None),
    ("bfloat16", 2, 300, 4, 2, 64, 70, 20.0),
    ("bfloat16", 1, 192, 4, 1, 128, 64, 30.0),
    ("bfloat16", 4, 1024, 16, 16, 64, None, None),
    # bf16 with a head dim the tensor-core kernel does not take
    ("bfloat16", 1, 100, 2, 2, 40, None, None)])
def test_flash_kernel_matches_plain(cuda_device, dtype, B, S, Hq, Hkv, D,
                                    window, cap):
    rng = np.random.default_rng(S + D)
    dt = getattr(torch, dtype)
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(dt).to(cuda_device)
    q, k, v = t(B, S, Hq, D), t(B, S, Hkv, D), t(B, S, Hkv, D)
    kw = dict(scale=D ** -0.5, window=window, cap=cap, bq=64, bk=64)
    assert tfa.flash_route(dt, D) == (
        ("mma" if D % 16 == 0 else "fma") if dtype == "bfloat16"
        else ("tf32x3" if D % 8 == 0 else "fma"))
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


@pytest.mark.cuda
def test_flash_tf32x3_prefill_error(cuda_device):
    """The 3xTF32 route at the prefill shape of qwen1.5-0.5b (B 4, S 1024,
    16 heads, D 64, causal): max abs error against the f32 plain version
    at most 1e-5, about f32's own."""
    rng = np.random.default_rng(20)
    q, k, v = (torch.from_numpy(rng.normal(size=(64, 1024, 64)).astype(
        np.float32)).to(cuda_device) for _ in range(3))
    assert tfa.flash_route(torch.float32, 64) == "tf32x3"
    out = tfa.flash_attention(q, k, v, scale=0.125)
    ref = tfa.flash_attention_plain(q, k, v, scale=0.125)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Hq,Hkv", [(5, 16, 16), (9, 16, 16), (9, 8, 2),
                                       (16, 16, 16)])
def test_paged_attn_kernel_at_verify_shapes(cuda_device, Sq, Hq, Hkv):
    """Speculative verification's Sq = k+1 query tokens per row, with a
    row whose queries run past its page table (a scratch row)."""
    ps, D, P = 16, 64, 127
    lens = np.asarray([0, 100, P * ps - Sq, P * ps], np.int32)
    rng = np.random.default_rng(Sq)
    n_pages = 1 + len(lens) * P
    t = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.normal(size=shape).astype(np.float32)).to(cuda_device)
    pages = np.stack([1 + b * P + rng.permutation(P)
                      for b in range(len(lens))]).astype(np.int32)
    args = (t(len(lens), Sq, Hq, D), t(n_pages, ps, Hkv, D),
            t(n_pages, ps, Hkv, D), torch.from_numpy(pages).to(cuda_device),
            torch.from_numpy(lens).to(cuda_device))
    before = tpa.paged_attn.sq_launches[Sq]
    out = tpa.paged_attn(*args, scale=D ** -0.5)
    torch.cuda.synchronize()
    assert tpa.paged_attn.sq_launches[Sq] == before + 1
    ref = tpa.paged_attn_plain(*args, tpa._NO_WINDOW, scale=D ** -0.5,
                               G=Hq // Hkv)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
def test_engine_graphs_give_the_eager_tokens(cuda_device, mode):
    """Reduced qwen1.5-0.5b, exact encoding, fused paged attention: the
    engine's CUDA graphs give the eager engine's tokens, with and without
    speculative decoding and the prefix cache, and the kernels' launch
    counts of a graphed serve are the eager serve's plus one warm-up
    forward per captured step."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, to_device
    from repro_torch.serve import (Engine, exact_encodings,
                                   prepare_encoded_serving)
    from repro_torch.kernels.counts import launch_counts
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              attention_backend="kernel")
    with tempfile.TemporaryDirectory() as cache:
        pe, ce, _ = prepare_encoded_serving(
            init_model(cfg, seed=0, device="cpu"), cfg,
            macs_override=exact_encodings(8), device="cpu", cache_dir=cache,
            verbose=False)
    pe = to_device(pe, cuda_device)
    ce = dataclasses.replace(ce, kv_cache_dtype=mode)
    rng = np.random.default_rng(0)
    trace = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (40, 13, 70, 7, 50, 33)]

    def serve(**kw):
        eng = Engine(pe, ce, n_slots=4, page_size=16, n_pages=64,
                     device=cuda_device, **kw)
        rids = [eng.submit(p, max_new=8) for p in trace]
        before = launch_counts()["encoded_matmul"]
        res = eng.run()
        torch.cuda.synchronize()
        return ([res[r].tolist() for r in rids], eng.stats(),
                launch_counts()["encoded_matmul"] - before)

    eager, st_e, n_e = serve(cuda_graphs=False)
    graphed, st_g, n_g = serve()
    assert graphed == eager
    assert st_e["jit_compiles"] == 0 and st_g["jit_compiles"] == 2
    assert n_g == n_e + 2 * 7 * cfg.n_layers
    for kw in (dict(spec_decode=4), dict(spec_decode=8, prefix_cache=True),
               dict(prefix_cache=True)):
        out, st, _ = serve(**kw)
        assert out == eager, kw
        assert st["jit_compiles"] == (3 if kw.get("spec_decode") else 2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma2-27b"])
def test_static_engine_graphs_keep_the_tokens(cuda_device, arch):
    """Reduced config, exact encoding: the static engine with its decode
    step as a CUDA graph gives the eager engine's tokens and the CPU's,
    one capture per chunk shape, and kernel 1 one warm-up forward more."""
    import dataclasses
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, to_device
    from repro_torch.serve import (ServeEngine, exact_encodings,
                                   prepare_encoded_serving)
    from repro_torch.kernels.counts import launch_counts
    cfg = get_config(arch).reduced()
    with tempfile.TemporaryDirectory() as cache:
        pe, ce, _ = prepare_encoded_serving(
            init_model(cfg, seed=0, device="cpu"), cfg,
            macs_override=exact_encodings(8), device="cpu", cache_dir=cache,
            verbose=False)
    rng = np.random.default_rng(0)
    trace = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
             for n in (40, 13, 90, 7, 70)]
    want = [o.tolist() for o in ServeEngine(pe, ce, batch_slots=2,
                                            device="cpu").run(trace, 8)]
    pg = to_device(pe, cuda_device)

    def serve(**kw):
        eng = ServeEngine(pg, ce, batch_slots=2, device=cuda_device, **kw)
        before = launch_counts()
        out = [o.tolist() for o in eng.run(trace, max_new=8)]
        after = launch_counts()
        return (out, eng.stats(),
                after["encoded_matmul"] - before["encoded_matmul"],
                after["paged_attn"] - before["paged_attn"])

    eager, st_e, n_e, pa_e = serve(cuda_graphs=False)
    graphed, st_g, n_g, pa_g = serve()
    assert graphed == eager == want
    assert st_e["jit_compiles"] == 0 and st_g["jit_compiles"] == 3
    assert n_g == n_e + 3 * 7 * cfg.n_layers
    assert pa_e == pa_g == 0
