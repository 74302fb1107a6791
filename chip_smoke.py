#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises and exits non-zero before the result line):

 1. card check: CUDA present; the card's name and power limit
    (``nvidia-smi``);
 2. build: every kernel from ``src/repro_torch/csrc``, one ``nvcc`` per
    source, all started together;
 3. kernel 1 (encoded bitplane matmul) against its plain PyTorch version
    on the card, at the main path's shapes, a sampled M = 48 program with
    3-bit monomials and ragged shapes (m past one 32-row pass, k and n
    off the tiles); and its rows at m = 4 bit for bit the same rows at
    m = 20 (speculative verification's m);
 4. kernel 2 (paged attention) against its plain version: ragged lens
    including 0 and page boundaries, f32 and bf16 pools, GQA, window +
    softcap, Sq = 3, 5 and 9 (speculative verification at k = 4 and 8),
    and the serve's 127-page table with an idle row and a row filling
    the table; then the same with int8 and packed-int4 pools
    (and the quantizer's codes and scales on the card against the CPU's,
    bit for bit), at the main path's decode shape too; one call is one
    CUDA kernel (``torch.profiler`` kernel events) for each pool type;
 5. kernel 3 (flash attention) through ``ops.flash_mha`` against its plain
    version: the prefill shape of full-width qwen1.5-0.5b in f32 (3xTF32
    tensor-core kernel, max abs error at most 1e-5) and bf16, ragged S =
    100, GQA, window, softcap, f32 head dims 32 and 128 (3xTF32) and 36
    (FMA), bf16 head dims 32 and 128 (bf16 tensor-core kernel) and 40
    (FMA);
 6. the main path: qwen1.5-0.5b at full width and depth (weights from seed
    0), calibrated encoded-MAC serving with the exact AND-plane encoding
    and the fused paged-attention kernel, continuous batching of 8
    requests over 4 slots, every engine step a captured CUDA graph, first
    with dense (f32) KV pools, then, from the same fold, with int8 and
    with int4 pools; the kernels' launch counts are set to 0 just before
    each run and read just after, and must equal what the run's forwards
    (the graphs' replays and their warm-ups) make.  Each pool type is
    served again eagerly (``cuda_graphs=False``): identical greedy tokens.
    The dense serve runs three more times on its warm engine (tokens/s and
    its spread), and one decode step with every slot busy is timed on the
    host clock with and without graphs, beside the decode graph's replay
    alone (the card's busy share);
 6c. the prefix cache: a trace where 4 of 8 requests share a 128-token
    prefix, served with the cache on and off (identical tokens, hits > 0),
    and ``copy_page`` on full-width dense, int8 and int4 card pools,
    scale rows included, in place and bit for bit;
 6d. speculative decoding over the main trace: k = 4 and 8 with the
    ``self`` drafter and k = 4 with an ``encoded`` drafter searched on the
    card at M = 24 (bundle in a fresh ``build/`` directory, removed
    after): tokens identical to plain decode, acceptance and tokens per
    round, launch counts by shape;
 6b. the main path with the paper's searched encodings: full-width
    qwen1.5-0.5b at the serving CLI's defaults (``--encoding search``, M
    = 48, 128 samples + 64 anneal steps per projection family, 4
    calibration batches), searched and folded on the card into a bundle
    under ``build/`` (removed at the end), served over the same trace
    with dense f32 pools through the kernels (and one decode step timed
    on the host clock and from a CUDA graph, as in phase 6), and kernel 1
    at each family's searched monomials and real folded weights against
    its plain version; a second start with the same params and options
    loads the bundle (a cache hit, timed) and must give the same circuits
    and folded leaves bit for bit;
 7. the reduced config and the same trace served on the card (kernels)
    and on the CPU (plain versions), with dense, int8 and int4 pools:
    identical greedy tokens (and, logged, how far one forward's linear
    inputs and int8 activation codes part between card and CPU);
 7b. the reduced config searched on the card and on the CPU: the same
    circuits for every family, or, where one differs, an anneal step
    whose candidates lie within 1e-6 of each other (a near-tie at f32
    rounding, logged and checked by replaying that step on both); the
    CPU loads the card's bundle (a cache hit); every encoded linear of
    one forward agrees card against CPU from the same input (and, logged,
    how far the two forwards' inputs and codes part); both serve
    the trace (greedy tokens compared and printed: an approximate product
    table turns one rounding-boundary activation code into a table error,
    so they part, ROADMAP Queue C);
 8. per-kernel times at the main path's shapes beside their bound, the
    plain version's time and a library call's, as one JSON line: kernel 1
    at its six shapes (three linears at decode m = 4 and at prefill
    m = 32), with the launches each shape had in the dense serve; kernel 2
    with each pool type at page tables of 32 and of the serve's 127
    pages, beside the launch floor (an empty kernel on the same grid and
    cluster); kernel 3 in f32 and bf16 at the prefill shape; kernel 1
    at the searched U (phase 6b) at its three decode shapes; kernel 1 at
    the verify shape m = 20 and kernel 2 at Sq = 5 and 9 (phase 6d).

Every phase that folds writes its bundle into a fresh directory under
``build/`` (git-ignored), logs the free disk first and removes it at its
end.  The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12

N_REQUESTS, MAX_NEW = 8, 32
N_SLOTS, PAGE_SIZE, N_PAGES = 4, 16, 256
# speculative decoding's main draft length (phase 6d also serves k = 8)
SPEC_K = 4
SERVE_P = 127          # the serve's page table: Engine's max_seq_pages


def log(msg: str) -> None:
    print(msg, flush=True)


def bundle_dir(tag: str) -> str:
    """A fresh bundle cache under ``build/`` (git-ignored), free disk
    logged first; the caller removes it."""
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    log(f"[{tag}] free disk under build/: "
        f"{shutil.disk_usage(root).free / 1e9:.1f} GB")
    return tempfile.mkdtemp(prefix=f"bundles-{tag}-", dir=root)


def make_trace(vocab: int, seed: int = 0):
    """8 prompts of 16–256 tokens from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 257, N_REQUESTS)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def time_loop(fn, arg_sets, iters: int = 20) -> float:
    """ms per call of ``fn`` issued from Python (host overhead included)."""
    import torch
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    s.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def card_check():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}"
        f" tf32 matmul={torch.backends.cuda.matmul.allow_tf32}")
    return torch.device("cuda", 0)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    for name, rep in reports.items():
        info = [ln.strip() for ln in rep.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: " + ("; ".join(info) or "cached"))
    log(f"[build] {len(reports)} sources in "
        f"{time.perf_counter() - t0:.1f}s")


def _program(kind):
    import numpy as np
    from repro_torch.core import circuits
    from repro_torch.core.decompose import decompose
    if kind == "exact":
        c, _ = circuits.exact_product_circuit(8, 8)
    else:                                  # seed 2: 3-bit activation monos
        gt, ii = circuits.sample_circuits(np.random.default_rng(2), 1, 48)
        c = circuits.Circuit(gt[0], ii[0])
    return decompose(c)


def _em_case(dev, prog, m, k, n, seed=0, copies=1):
    import torch
    g = torch.Generator().manual_seed(seed)
    U = prog.n_a_planes
    x = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    sets = []
    for _ in range(copies):
        # exact-fold magnitudes: 2^i · code, |value| ≤ 128·127
        wt = torch.randint(-127, 128, (U, k, n), generator=g).float()
        wt *= (2.0 ** (torch.arange(U) % 8).float()).reshape(U, 1, 1)
        bias = torch.randn((n,), generator=g) * 100
        sets.append((x.to(dev), wt.to(torch.bfloat16).to(dev), bias.to(dev),
                     prog.a_mono_bits))
    return sets


def phase_kernel1(dev):
    import torch
    from repro_torch.kernels import encoded_matmul as em
    exact, sampled = _program("exact"), _program("sampled")
    assert max(len(t) for t in sampled.a_mono_tuples) == 3
    cases = [("exact", exact, m, k, n) for m in (1, 4, 32)
             for k, n in ((1024, 1024), (1024, 2816), (2816, 1024))]
    # speculative verification's m = n_slots·(k+1): 20 at k = 4, 36 at
    # k = 8 (two 32-row passes)
    cases += [(tag, prog, m, k, n)
              for tag, prog in (("exact", exact), ("sampled48", sampled))
              for m in (N_SLOTS * (SPEC_K + 1), N_SLOTS * (8 + 1))
              for k, n in ((1024, 1024), (1024, 2816), (2816, 1024))]
    cases += [("sampled48", sampled, 4, 1024, 2816),
              ("sampled48", sampled, 32, 2816, 1024),
              ("ragged", exact, 100, 130, 70),
              ("ragged", sampled, 5, 77, 33),
              ("ragged", exact, 33, 1024, 70),
              ("ragged", sampled, 100, 2816, 1024)]
    worst = 0.0
    for tag, prog, m, k, n in cases:
        (args,) = _em_case(dev, prog, m, k, n, seed=m * 7 + k + n)
        out = em.encoded_matmul(*args)
        ref = em.encoded_matmul_plain(*args)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        ok = torch.allclose(out, ref, rtol=1e-4, atol=tol)
        log(f"[kernel1] {tag:9s} U={prog.n_a_planes:2d} m={m:3d} k={k:4d} "
            f"n={n:4d} max_abs_err={err:.3e} (atol {tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel1 disagrees with plain at {tag} "
                                 f"{(m, k, n)}")
        worst = max(worst, err / max(ref.abs().max().item(), 1e-30))
    log(f"[kernel1] all {len(cases)} cases within tolerance "
        f"(worst err / max|ref| = {worst:.3e})")
    # a row's sums do not depend on m: the decode step (m = 4 slots) and
    # speculative verification (m = 4·(k+1) = 20 at k = 4) give the same
    # row bit for bit, so spec decoding can keep plain decode's tokens
    for tag, prog in (("exact", exact), ("sampled48", sampled)):
        for k, n in ((1024, 1024), (1024, 2816), (2816, 1024)):
            (args,) = _em_case(dev, prog, 20, k, n, seed=k + n)
            x, wt, bias, sh = args
            full = em.encoded_matmul(x, wt, bias, sh)
            head = em.encoded_matmul(x[:N_SLOTS].contiguous(), wt, bias, sh)
            torch.cuda.synchronize()
            same = torch.equal(full[:N_SLOTS], head)
            log(f"[kernel1] {tag} k={k} n={n}: rows 0-3 at m=20 and at "
                f"m=4 {'bit-identical' if same else 'DIFFER'}")
            if not same:
                raise AssertionError(f"kernel 1's rows depend on m ({tag} "
                                     f"k={k} n={n})")


def _pa_case(dev, B, Sq, Hq, Hkv, D, ps, P, lens, dtype, seed=0, copies=1):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * P
    g = max(1, Hq // Hkv)
    kv_map = np.minimum(np.arange(Hq) // g, Hkv - 1).astype(np.int32)
    pages = np.zeros((B, P), np.int32)
    for b in range(B):
        pages[b] = 1 + b * P + rng.permutation(P)
    sets = []
    for _ in range(copies):
        t = lambda shape: torch.from_numpy(          # noqa: E731
            rng.normal(size=shape).astype(np.float32)).to(dtype).to(dev)
        sets.append((t((B, Sq, Hq, D)), t((n_pages, ps, Hkv, D)),
                     t((n_pages, ps, Hkv, D)),
                     torch.from_numpy(pages).to(dev),
                     torch.from_numpy(np.asarray(lens, np.int32)).to(dev)))
    return sets, kv_map


def _one_kernel(fn, what):
    """One call of ``fn`` runs exactly one CUDA kernel (profiler events)."""
    from repro_torch.launch.kernel_bench import cuda_kernels_of
    names = cuda_kernels_of(fn)
    log(f"[kernel2] one call of {what}: {len(names)} CUDA kernel(s) {names}")
    if len(names) != 1:
        raise AssertionError(f"{what}: {len(names)} CUDA kernels in one "
                             f"paged_attn call, not 1: {names}")


def phase_kernel2(dev):
    import torch
    from repro_torch.kernels import paged_attention as pa
    ps, D = 16, 64
    lens = [0, 16, 17, 511]
    cases = [("mha-f32", 1, 16, 16, None, None, torch.float32, 32),
             ("mha-bf16", 1, 16, 16, None, None, torch.bfloat16, 32),
             ("gqa-f32", 1, 16, 4, None, None, torch.float32, 32),
             ("win+cap", 1, 16, 4, 100, 30.0, torch.float32, 32),
             ("sq3-gqa", 3, 16, 4, None, None, torch.float32, 32),
             # speculative verification: Sq = k+1 for k = 4 and 8
             ("sq5", 5, 16, 16, None, None, torch.float32, SERVE_P),
             ("sq9", 9, 16, 16, None, None, torch.float32, SERVE_P),
             ("sq9-bf16", 9, 16, 16, None, None, torch.bfloat16, SERVE_P),
             ("sq9-gqa", 9, 16, 4, 100, 30.0, torch.float32, 32),
             ("p127-f32", 1, 16, 16, None, None, torch.float32, SERVE_P),
             ("p127-bf16", 1, 16, 16, None, None, torch.bfloat16, SERVE_P)]
    for tag, Sq, Hq, Hkv, window, cap, dtype, P in cases:
        # the serve's table: an idle row and a row filling the table
        ln = ([0, 100, 288, P * ps - Sq] if P == SERVE_P
              else [min(x, P * ps - Sq) for x in lens])
        (args,), kv_map = _pa_case(dev, 4, Sq, Hq, Hkv, D, ps, P, ln, dtype,
                                   seed=Hq + Hkv + Sq)
        kw = dict(scale=D ** -0.5, window=window, cap=cap)
        out = pa.paged_attn(*args, kv_of_q=kv_map, **kw)
        ref = pa.paged_attn_plain(*args, window or pa._NO_WINDOW,
                                  scale=D ** -0.5, cap=cap, G=Hq // Hkv)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = (dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32
               else dict(rtol=0.0, atol=2e-2))
        ok = torch.allclose(out.float(), ref.float(), **tol) and \
            bool(torch.isfinite(out.float()).all())
        log(f"[kernel2] {tag:9s} B=4 Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
            f"ps={ps} P={P} lens={ln} max_abs_err={err:.3e} {tol} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel2 disagrees with plain at {tag}")
        if tag == "p127-f32":
            _one_kernel(lambda: pa.paged_attn(*args, kv_of_q=kv_map, **kw),
                        "paged_attn (dense f32 pools, P = 127)")


def _pa_quant_case(dev, mode, B, Sq, Hq, Hkv, D, ps, P, lens, seed=0,
                  copies=1):
    """Like ``_pa_case`` with pools quantized on the card: (q, pool_k,
    pool_v, pages, lens) and the scale rows (scale_k, scale_v)."""
    import torch
    from repro_torch.quant.kvcache import quantize_kv
    sets, kv_map = _pa_case(dev, B, Sq, Hq, Hkv, D, ps, P, lens,
                            torch.float32, seed=seed, copies=copies)
    out = []
    for q, pk, pv, pages, ln in sets:
        qk, sk = quantize_kv(pk, mode)
        qv, sv = quantize_kv(pv, mode)
        out.append(((q, qk, qv, pages, ln), (sk, sv)))
    return out, kv_map


def phase_kernel2_quant(dev):
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.quant.kvcache import quantize_kv
    # the quantizer on the card must give the CPU's codes and scales
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(256, 16, 16, 64)).astype(np.float32) * 3)
    x[0] = 0.0
    for mode in ("int8", "int4"):
        qc, sc = quantize_kv(x, mode)
        qg, sg = quantize_kv(x.to(dev), mode)
        same = torch.equal(qg.cpu(), qc) and torch.equal(sg.cpu(), sc)
        log(f"[kernel2q] quantize_kv {mode} on the card vs the CPU, "
            f"{tuple(x.shape)}: {'bit for bit' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"quantize_kv {mode}: card and CPU differ")
    ps, D = 16, 64
    lens = [0, 16, 17, 511]
    cases = [("mha", 1, 16, 16, None, None, lens, 32),
             ("gqa", 1, 4, 2, None, None, lens, 32),
             ("win+cap", 1, 16, 4, 100, 30.0, lens, 32),
             ("sq3-gqa", 3, 4, 2, None, None, lens, 32),
             ("decode", 1, 16, 16, None, None, [100, 200, 300, 400], 32),
             ("p127", 1, 16, 16, None, None,
              [0, 100, 288, SERVE_P * ps - 1], SERVE_P)]
    # the f32 sums run in another order on the card (and exp differs by
    # ulps): the dense kernel's f32 tolerance, not the CPU tests' 2e-5
    tol = dict(rtol=1e-4, atol=1e-5)
    for mode in ("int8", "int4"):
        for tag, Sq, Hq, Hkv, window, cap, ln, P in cases:
            ln = [min(x, P * ps - Sq) for x in ln]
            ((args, (sk, sv)),), kv_map = _pa_quant_case(
                dev, mode, 4, Sq, Hq, Hkv, D, ps, P, ln, seed=Hq + Sq)
            out = pa.paged_attn(*args, scale=D ** -0.5, window=window,
                                cap=cap, kv_of_q=kv_map, scale_k=sk,
                                scale_v=sv)
            ref = pa.paged_attn_plain(*args, window or pa._NO_WINDOW,
                                      scale=D ** -0.5, cap=cap,
                                      G=Hq // Hkv, scale_k=sk, scale_v=sv)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = torch.allclose(out, ref, **tol) and \
                bool(torch.isfinite(out).all())
            log(f"[kernel2q] {mode} {tag:8s} B=4 Sq={Sq} Hq={Hq} Hkv={Hkv} "
                f"D={D} ps={ps} P={P} lens={ln} max_abs_err={err:.3e} {tol} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel2 {mode} disagrees with plain "
                                     f"at {tag}")
            if tag == "p127":
                _one_kernel(lambda: pa.paged_attn(
                    *args, scale=D ** -0.5, kv_of_q=kv_map, scale_k=sk,
                    scale_v=sv), f"paged_attn ({mode} pools, P = 127)")


def _flash_case(dev, B, S, Hq, Hkv, D, dtype, seed=0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(
        np.float32)).to(dtype).to(dev) for h in (Hq, Hkv, Hkv))


def _flash_plain_4d(q, k, v, **kw):
    """The plain version at ``flash_mha``'s 4-D layout and padding."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ops import _pad_to
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    bq, bk = kw.pop("bq", 128), kw.pop("bk", 128)
    flat = lambda x, H, m: _pad_to(                      # noqa: E731
        x.permute(0, 2, 1, 3).reshape(B * H, S, D), m, 1)
    out = fa.flash_attention_plain(flat(q, Hq, bq), flat(k, Hkv, bk),
                                   flat(v, Hkv, bk), bq=bq, bk=bk,
                                   G=Hq // Hkv, **kw)
    return out[:, :S].reshape(B, Hq, S, D).permute(0, 2, 1, 3)


def phase_flash(dev):
    import torch
    from repro_torch.kernels import ops
    cases = [("prefill-f32", 4, 1024, 16, 16, 64, None, None, torch.float32),
             ("prefill-bf16", 4, 1024, 16, 16, 64, None, None,
              torch.bfloat16),
             ("ragged100", 2, 100, 16, 16, 64, None, None, torch.float32),
             ("ragged100-bf16", 2, 100, 4, 4, 64, None, None,
              torch.bfloat16),
             ("gqa-4/2", 2, 256, 4, 2, 64, None, None, torch.float32),
             ("window32", 2, 256, 4, 2, 64, 32, None, torch.float32),
             ("softcap", 2, 256, 4, 4, 64, None, 30.0, torch.float32),
             ("d32-f32", 2, 300, 8, 2, 32, None, None, torch.float32),
             ("d128-f32", 1, 200, 4, 4, 128, 70, None, torch.float32),
             ("gqa-win+cap", 2, 130, 8, 2, 64, 48, 20.0, torch.float32),
             ("d36-f32", 1, 100, 2, 2, 36, None, None, torch.float32),
             ("win+cap-bf16", 2, 256, 4, 2, 128, 32, 20.0, torch.bfloat16),
             ("d32-bf16", 2, 300, 8, 2, 32, None, None, torch.bfloat16),
             ("d128-bf16", 1, 200, 4, 4, 128, 70, None, torch.bfloat16),
             ("d40-bf16", 1, 100, 2, 2, 40, None, None, torch.bfloat16)]
    from repro_torch.kernels.flash_attention import flash_route
    for tag, B, S, Hq, Hkv, D, window, cap, dt in cases:
        q, k, v = _flash_case(dev, B, S, Hq, Hkv, D, dt, seed=S + Hq)
        kw = dict(scale=D ** -0.5, window=window, cap=cap)
        out = ops.flash_mha(q, k, v, **kw)
        ref = _flash_plain_4d(q, k, v, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = 2e-4 if dt == torch.float32 else 3e-2
        ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol) \
            and bool(torch.isfinite(out.float()).all())
        log(f"[flash] {tag:14s} B={B} S={S} Hq={Hq} Hkv={Hkv} D={D} "
            f"window={window} cap={cap} route={flash_route(dt, D)} "
            f"max_abs_err={err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with plain at "
                                 f"{tag}")
        if tag == "prefill-f32":
            # 3xTF32 keeps about f32 accuracy on the tensor cores
            assert flash_route(dt, D) == "tf32x3"
            if not err <= 1e-5:
                raise AssertionError(f"tf32x3 max abs error {err:.3e} at "
                                     "the prefill shape is above 1e-5")


def _serve(params, cfg, trace, device, max_new: int = MAX_NEW, **kw):
    from repro_torch.serve import Engine
    eng = Engine(params, cfg, n_slots=N_SLOTS, page_size=PAGE_SIZE,
                 n_pages=N_PAGES, device=device, **kw)
    rids = [eng.submit(p, max_new=max_new) for p in trace]
    return eng, rids


def _reset_counts():
    from repro_torch.kernels.counts import set_launch_counts
    set_launch_counts({})


def _read_counts():
    from repro_torch.kernels.counts import launch_counts
    return {k: dict(v) if isinstance(v, dict) else v
            for k, v in launch_counts().items()}


# the serving path's kernels; flash attention is not on it (the reference
# never routes its model through the flash kernel, and the port mirrors
# that), so its count must stay 0 there
PATH_KERNELS = ("encoded_matmul", "paged_attn")


def _forwards(st, chunk_len):
    """Model forwards of a serve by the rows of their linears (m): decode
    steps at m = n_slots, prefill chunks at m = chunk_len, and, with
    speculative decoding, k draft steps at m = n_slots and one verify at
    m = n_slots·(k+1) per round; plus the one eager warm-up run of each
    step that the engine captured into a CUDA graph.  Also returns the
    forwards whose attention runs kernel 2 (all but prefill), by Sq."""
    warm = st["jit_compiles_by_step"]
    k = st.get("spec_decode_k", 0)
    rounds = st.get("spec_rounds", 0)
    by_m = collections.Counter()
    by_m[chunk_len] += st["prefill_chunks"] + warm["prefill"]
    by_m[N_SLOTS] += st["decode_steps"] + warm["decode"]
    attn = collections.Counter({1: st["decode_steps"] + warm["decode"]})
    if k:
        by_m[N_SLOTS] += k * (rounds + warm["draft"])
        by_m[N_SLOTS * (k + 1)] += rounds + warm["verify"]
        attn[1] += k * (rounds + warm["draft"])
        attn[k + 1] += rounds + warm["verify"]
    return +by_m, +attn


def _check_counts(counts, st, cfg, chunk_len, where):
    """Every kernel of the path launched, paged attention once per layer
    per forward that attends through it (prefill chunks take the gather
    path), by query tokens per row; encoded matmul at every linear of
    every forward, by (m, k, n); flash never."""
    by_m, attn = _forwards(st, chunk_len)
    for name in PATH_KERNELS:
        assert counts[name] > 0, f"{name} was not launched {where}"
    want = {sq: cfg.n_layers * n for sq, n in attn.items()}
    assert counts["paged_attn_by_sq"] == want, \
        f"paged_attn launched {counts['paged_attn_by_sq']} times by Sq " \
        f"{where}, not {cfg.n_layers} per layer x {dict(attn)}"
    assert counts["paged_attn"] == sum(want.values())
    shapes = _path_shapes(cfg, by_m)
    assert counts["encoded_matmul_by_shape"] == shapes, \
        f"encoded_matmul shapes {counts['encoded_matmul_by_shape']} " \
        f"!= {shapes} {where}"
    assert counts["flash_attention"] == 0, f"flash launched {where}"


def _path_shapes(cfg, forwards):
    """Encoded-matmul launches by (m, k, n) of ``forwards`` ({m: model
    forwards with m rows per linear}): per layer wq, wk, wv, wo, wi, wg
    and the MLP's wo."""
    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_r
    per_layer = [(d, cfg.n_heads_p * hd), (d, cfg.n_kv_p * hd),
                 (d, cfg.n_kv_p * hd), (cfg.n_heads_p * hd, d), (d, ff),
                 (d, ff), (ff, d)]
    want = {}
    for m, times in forwards.items():
        for k, n in per_layer:
            want[(m, k, n)] = want.get((m, k, n), 0) + cfg.n_layers * times
    return want


def _timed_run(eng, rids):
    """Drain ``eng``: (outputs by rid, seconds, launch counts, stats)."""
    import torch
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return outs, dt, _read_counts(), eng.stats()


def _spread(xs):
    xs = sorted(xs)
    return (f"{', '.join(f'{x:.1f}' for x in xs)} (min {xs[0]:.1f}, "
            f"max {xs[-1]:.1f}, spread {(xs[-1] - xs[0]) / xs[-1]:.1%} "
            f"of max)")


def phase_serve(dev):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import apply_model, init_model
    from repro_torch.serve import exact_encodings, prepare_encoded_serving
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              attention_backend="kernel")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=dev)
    log(f"[serve] {cfg.arch}: {cfg.n_layers} layers d={cfg.d_model} "
        f"ff={cfg.d_ff} vocab={cfg.vocab_size}, init from seed 0 in "
        f"{time.perf_counter() - t0:.1f}s")
    cache = bundle_dir("serve")
    t0 = time.perf_counter()
    params_enc, cfg_enc, info = prepare_encoded_serving(
        params, cfg, macs_override=exact_encodings(cfg.mac.bits),
        device=dev, cache_dir=cache, verbose=False)
    torch.cuda.synchronize()
    log(f"[serve] bundle {info['bundle_bytes'] / 1e9:.3f} GB written in "
        f"{info['seconds']['write']:.1f}s")
    shutil.rmtree(cache)
    fw = sum(t.numel() * t.element_size() for layer in params_enc["layers"]
             for sub in layer.values() if isinstance(sub, dict)
             for k, t in sub.items() if k.endswith("_fw"))
    log(f"[serve] calibrated ({info['calib_tokens']} tokens) and folded "
        f"{info['n_folded']} linears in {time.perf_counter() - t0:.1f}s; "
        f"folded bf16 Wt {fw / 1e9:.3f} GB; device memory "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    trace = make_trace(cfg.vocab_size)
    # warm-up (module loads, allocator) on a separate engine
    warm, _ = _serve(params_enc, cfg_enc, trace[:1], dev)
    warm.run()
    del warm
    eng, rids = _serve(params_enc, cfg_enc, trace, dev)
    outs, dt, counts, st = _timed_run(eng, rids)
    n_tok = sum(len(outs[r]) for r in rids)
    log(f"[serve] prompts {[len(p) for p in trace]} max_new={MAX_NEW} "
        f"slots={N_SLOTS} ps={PAGE_SIZE} pages={N_PAGES}")
    log(f"[serve] CUDA graphs: {len(outs)} requests, {n_tok} tokens in "
        f"{dt:.3f}s = {n_tok / dt:.1f} tok/s (graph captures included: "
        f"{st['jit_compiles_by_step']}); decode steps {st['decode_steps']},"
        f" prefill chunks {st['prefill_chunks']}, step p50 "
        f"{st['step_ms_p50']:.2f} ms p99 {st['step_ms_p99']:.2f} ms, "
        f"kv pool {st['kv_pool_bytes'] / 1e9:.3f} GB")
    log(f"[serve] launches: encoded_matmul {counts['encoded_matmul']} "
        f"paged_attn {counts['paged_attn']} flash_attention "
        f"{counts['flash_attention']}")
    assert st["cuda_graphs"] and st["jit_compiles"] == 2, \
        f"the engine captured {st['jit_compiles_by_step']}, not prefill " \
        "and decode once each"
    assert len(outs) == N_REQUESTS and all(
        len(outs[r]) == MAX_NEW for r in rids), "not every request finished"
    assert all(0 <= t < cfg.vocab_size for r in rids for t in outs[r])
    log(f"[serve] encoded_matmul launches by (m, k, n): "
        f"{counts['encoded_matmul_by_shape']}")
    _check_counts(counts, st, cfg, eng.prefill_chunk, "on the main path")
    tokens = [outs[r].tolist() for r in rids]
    # the same trace served again on the warm engine (its graphs already
    # captured), three times: tokens/s and its spread within one run
    warm_tok_s, steps_p50 = [], []
    for _ in range(3):
        n0 = len(eng.step_ms)
        rids2 = [eng.submit(p, max_new=MAX_NEW) for p in trace]
        outs2, dt2, _, st2 = _timed_run(eng, rids2)
        assert [outs2[r].tolist() for r in rids2] == tokens
        warm_tok_s.append(n_tok / dt2)
        steps_p50.append(float(np.percentile(eng.step_ms[n0:], 50)))
    log(f"[serve] warm engine, 3 more serves of the trace: tok/s "
        f"{_spread(warm_tok_s)}; step p50 "
        f"{', '.join(f'{x:.2f}' for x in steps_p50)} ms; "
        f"jit_compiles still {st2['jit_compiles']}; tokens identical")
    # the same step functions without graphs: the tokens must not move
    eager, rids_e = _serve(params_enc, cfg_enc, trace, dev, cuda_graphs=False)
    outs_e, dt_e, counts_e, st_e = _timed_run(eager, rids_e)
    same = [outs_e[r].tolist() for r in rids_e] == tokens
    log(f"[serve] eager (cuda_graphs=False): {n_tok / dt_e:.1f} tok/s, step "
        f"p50 {st_e['step_ms_p50']:.2f} ms p99 {st_e['step_ms_p99']:.2f} ms;"
        f" greedy tokens graphs vs eager "
        f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("graphed and eager greedy tokens differ")
    _check_counts(counts_e, st_e, cfg, eager.prefill_chunk, "eagerly")
    del eager
    # full-width logits: finite, and close to the fp model's on one prompt
    toks = torch.from_numpy(trace[0][:16])[None].to(dev)
    with torch.inference_mode():
        lg_enc, _ = apply_model(params_enc, cfg_enc, toks)
        lg_fp, _ = apply_model(params, cfg, toks)
    assert lg_enc.shape == (1, 16, cfg.vocab_p)
    assert bool(torch.isfinite(lg_enc).all()), "non-finite logits"
    agree = (lg_enc.argmax(-1) == lg_fp.argmax(-1)).float().mean().item()
    rel = ((lg_enc - lg_fp).abs().max() / lg_fp.abs().max()).item()
    log(f"[serve] full-width encoded vs fp logits: top-1 agreement "
        f"{agree:.3f}, max |diff| / max |fp| {rel:.3e}")
    split = step_split(dev, params_enc, cfg_enc, trace)
    return {"counts": counts, "steps": st["decode_steps"],
            "chunks": st["prefill_chunks"], "tok_s": n_tok / dt,
            "warm_tok_s": warm_tok_s, "eager_tok_s": n_tok / dt_e,
            "split": split, "params": params, "cfg": cfg,
            "params_enc": params_enc, "cfg_enc": cfg_enc, "trace": trace,
            "tokens": tokens, "stats": st}


def phase_serve_quant(dev, dense):
    """The main path again with int8, then int4 KV pools, from the dense
    run's fold (calibration does not depend on the KV dtype), graphed and
    eager."""
    import torch
    params, cfg0, trace = (dense["params_enc"], dense["cfg_enc"],
                           dense["trace"])
    st0 = dense["stats"]
    out = {}
    for mode in ("int8", "int4"):
        cfg = dataclasses.replace(cfg0, kv_cache_dtype=mode)
        eng, rids = _serve(params, cfg, trace, dev)
        res, dt, counts, st = _timed_run(eng, rids)
        toks = [res[r].tolist() for r in rids]
        n_tok = sum(map(len, toks))
        same = sum(a == b for x, y in zip(toks, dense["tokens"])
                   for a, b in zip(x, y))
        log(f"[serve-{mode}] {len(res)} requests, {n_tok} tokens in "
            f"{dt:.3f}s = {n_tok / dt:.1f} tok/s; decode steps "
            f"{st['decode_steps']}, prefill chunks {st['prefill_chunks']}, "
            f"step p50 {st['step_ms_p50']:.2f} ms p99 "
            f"{st['step_ms_p99']:.2f} ms")
        log(f"[serve-{mode}] kv {st['kv_cache_dtype']}: "
            f"{st['kv_bytes_per_token']:.1f} B/token (dense f32 pools "
            f"{st0['kv_bytes_per_token']:.1f}, "
            f"{st0['kv_bytes_per_token'] / st['kv_bytes_per_token']:.2f}x "
            f"fewer), pool {st['kv_pool_bytes'] / 1e6:.1f} MB against "
            f"{st0['kv_pool_bytes'] / 1e6:.1f} MB")
        log(f"[serve-{mode}] launches: encoded_matmul "
            f"{counts['encoded_matmul']} paged_attn {counts['paged_attn']} "
            f"flash_attention {counts['flash_attention']}")
        log(f"[serve-{mode}] greedy tokens equal to the dense-pool run's: "
            f"{same} of {n_tok} ({same / n_tok:.3f}; printed, not gated: "
            "quantized KV is not expected to give identical tokens)")
        assert len(res) == N_REQUESTS and all(
            len(t) == MAX_NEW for t in toks), "not every request finished"
        assert all(0 <= t < cfg.vocab_size for x in toks for t in x)
        _check_counts(counts, st, cfg, eng.prefill_chunk,
                      f"with {mode} pools")
        del eng
        eager, rids_e = _serve(params, cfg, trace, dev, cuda_graphs=False)
        res_e, dt_e, _, st_e = _timed_run(eager, rids_e)
        same_e = [res_e[r].tolist() for r in rids_e] == toks
        log(f"[serve-{mode}] eager: {n_tok / dt_e:.1f} tok/s, step p50 "
            f"{st_e['step_ms_p50']:.2f} ms; greedy tokens graphs vs eager "
            f"{'identical' if same_e else 'DIFFERENT'}")
        if not same_e:
            raise AssertionError(f"graphed and eager greedy tokens differ "
                                 f"with {mode} pools")
        out[mode] = {"counts": counts, "steps": st["decode_steps"],
                     "tok_s": n_tok / dt, "eager_tok_s": n_tok / dt_e}
        del eager
    torch.cuda.empty_cache()
    return out


def step_split(dev, params, cfg, trace, steps: int = 10):
    """Host against device time of one full-width decode step with every
    slot decoding: the engine's step on the host clock with its CUDA
    graphs and without (``cuda_graphs=False``), and the decode graph's
    replay alone on the card (CUDA events), whose share of the graphed
    step is the card's busy share."""
    import torch
    host = {}
    for graphs in (True, False):
        eng, _ = _serve(params, cfg, trace[:N_SLOTS], dev,
                        max_new=4 * MAX_NEW, cuda_graphs=graphs)
        while eng.counters["prefills"] < N_SLOTS:
            eng.step()
        eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        host[graphs] = (time.perf_counter() - t0) / steps * 1e3
        if graphs:
            g = eng.steps["decode"].graph
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            s.record()
            for _ in range(steps):
                g.replay()
            e.record()
            torch.cuda.synchronize()
            dev_ms = s.elapsed_time(e) / steps
            split = _replay_split(eng.steps["decode"])
        del eng
    log(f"[step] {N_SLOTS} slots decoding: engine step {host[True]:.3f} ms "
        f"with CUDA graphs, {host[False]:.3f} ms eager, on the host clock; "
        f"the decode graph's replay {dev_ms:.3f} ms on the card; device "
        f"busy share {dev_ms / host[True]:.3f} with graphs, "
        f"{dev_ms / host[False]:.3f} eager")
    return {"graph_ms": host[True], "eager_ms": host[False],
            "replay_ms": dev_ms, "kernels": split}


# the kernels a graph's replay counts, by a word of their device names
GRAPH_KERNELS = {"encoded_matmul": "encoded_matmul", "paged_attn": "paged_attn",
                 "flash_attention": "flash_fwd"}


def _replay_split(step):
    """Device time of one replay of ``step``'s graph by kind of kernel
    (``torch.profiler``): kernel 1, kernel 2, the library's matrix
    products (the LM head) and every other kernel, in ms, with counts.
    Fails unless the replay ran each hand-written kernel as many times as
    the step adds to its launch counter per replay (``Step.delta``)."""
    from repro_torch.launch.kernel_bench import cuda_kernel_times
    out = collections.defaultdict(lambda: [0.0, 0])
    events = cuda_kernel_times(step.graph.replay)
    for name, us in events:
        kind = next((k for k, word in GRAPH_KERNELS.items() if word in name),
                    "library_gemm" if "gemm" in name.lower() else "other")
        out[kind][0] += us / 1e3
        out[kind][1] += 1
    total = sum(v[0] for v in out.values())
    log(f"[step] one {step.name} replay under torch.profiler: "
        f"{len(events)} device kernels, {total:.3f} ms of kernel time: " +
        ", ".join(f"{k} {v[0]:.3f} ms in {v[1]}"
                  for k, v in sorted(out.items())))
    ran = {k: out[k][1] if k in out else 0 for k in GRAPH_KERNELS}
    counted = {k: step.delta[k] for k in GRAPH_KERNELS}
    log(f"[step] {step.name} graph: kernels run per replay {ran}, counted "
        f"per replay {counted}: {'equal' if ran == counted else 'DIFFER'}")
    if ran != counted:
        raise AssertionError(f"the {step.name} graph runs {ran} kernels but "
                             f"its replays count {counted}")
    return {k: v[0] for k, v in out.items()}


def _prefix_trace(vocab: int):
    """8 prompts from seed 1; prompts 0, 2, 5 and 7 share a 128-token
    prefix (their own tails 16–64 tokens), the others are 16–256 tokens of
    their own.  With 4 slots, 0 and 2 are admitted cold and 5 and 7 after
    the prefix is indexed."""
    import numpy as np
    rng = np.random.default_rng(1)
    shared = rng.integers(0, vocab, 128).astype(np.int32)
    out = []
    for i in range(N_REQUESTS):
        if i in (0, 2, 5, 7):
            tail = rng.integers(0, vocab, int(rng.integers(16, 65)))
            out.append(np.concatenate([shared, tail.astype(np.int32)]))
        else:
            out.append(rng.integers(0, vocab, int(rng.integers(16, 257)))
                       .astype(np.int32))
    return out


def phase_prefix(dev, info):
    """The prefix cache at full width: the shared-prefix trace served with
    the cache on and off (graphed, exact encoding, dense pools), and
    ``copy_page`` on the card pools, checked bit for bit."""
    import torch
    from repro_torch.serve import PagedKVCache
    params, cfg = info["params_enc"], info["cfg_enc"]
    trace = _prefix_trace(cfg.vocab_size)
    runs = {}
    for on in (False, True):
        eng, rids = _serve(params, cfg, trace, dev, prefix_cache=on)
        outs, dt, counts, st = _timed_run(eng, rids)
        runs[on] = ([outs[r].tolist() for r in rids], dt, st)
        n_tok = sum(len(outs[r]) for r in rids)
        log(f"[prefix] cache {'on' if on else 'off'}: {n_tok} tokens in "
            f"{dt:.3f}s = {n_tok / dt:.1f} tok/s; prefill tokens "
            f"{st['prefill_tokens']} in {st['prefill_chunks']} chunks, "
            f"decode steps {st['decode_steps']}, step p50 "
            f"{st['step_ms_p50']:.2f} ms; hit rate "
            f"{st['prefix_hit_rate']:.3f} ({st['prefix_hit_tokens']}/"
            f"{st['prefix_lookup_tokens']} tokens), "
            f"{st['prefix_pages_indexed']} pages indexed, copy-on-write "
            f"{st['cow_copies']}")
        _check_counts(counts, st, cfg, eng.prefill_chunk,
                      f"with the prefix cache {'on' if on else 'off'}")
        del eng
    same = runs[True][0] == runs[False][0]
    st = runs[True][2]
    log(f"[prefix] greedy tokens with the cache against without: "
        f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("prefix-cache tokens differ from cold tokens")
    if st["prefix_hit_tokens"] <= 0:
        raise AssertionError("the shared-prefix trace had no prefix hit")
    # copy-on-write's page copy on full-width card pools, every pool type
    g = torch.Generator(device=dev).manual_seed(0)
    for mode in ("bf16", "int8", "int4"):
        c = dataclasses.replace(cfg, kv_cache_dtype=mode)
        kv = PagedKVCache(c, N_SLOTS, N_PAGES, PAGE_SIZE, SERVE_P,
                          device=dev)
        for st_ in kv.layers:
            for t in st_.values():
                if t.dtype.is_floating_point:
                    t.copy_(torch.randn(t.shape, generator=g, device=dev))
                else:
                    t.copy_(torch.randint(0, 120, t.shape, generator=g,
                                          device=dev))
        leaves = [t for st_ in kv.layers for t in st_.values()]
        ptrs = [t.data_ptr() for t in leaves]
        before = [t.clone() for t in leaves]
        kv.copy_page(7, 200)
        torch.cuda.synchronize()
        keep = [p for p in range(N_PAGES) if p != 200]
        ok = ([t.data_ptr() for t in leaves] == ptrs and all(
            torch.equal(t[200], b[7]) and torch.equal(t[keep], b[keep])
            for t, b in zip(leaves, before)))
        names = sorted(kv.layers[0])
        log(f"[prefix] copy_page on {mode} pools ({len(leaves)} tensors: "
            f"{names} x {c.n_layers} layers): in place and bit for bit "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"copy_page on {mode} pools")
        del kv, leaves, before
    torch.cuda.empty_cache()
    return {"tok_s": {on: sum(map(len, r[0])) / r[1]
                      for on, r in runs.items()},
            "hit_rate": st["prefix_hit_rate"],
            "hit_tokens": st["prefix_hit_tokens"],
            "cow_copies": st["cow_copies"]}



def phase_spec(dev, info):
    """Speculative decoding at full width over the main trace, graphed:
    k = 4 and 8 with the ``self`` drafter and k = 4 with an ``encoded``
    drafter searched on the card at M = 24 (the CLI's drafter default;
    bundle in a fresh ``build/`` directory, removed after).  Tokens must
    be the plain (spec_decode = 0) serve's, on a fresh and a warm engine."""
    import numpy as np
    import torch
    from repro_torch.serve import prepare_drafter
    params, cfg = info["params_enc"], info["cfg_enc"]
    trace, plain = info["trace"], info["tokens"]
    cache = bundle_dir("draft")
    t0 = time.perf_counter()
    dp, dc, dinfo = prepare_drafter(info["params"], info["cfg"], m_bits=24,
                                    cache_dir=cache, device=dev,
                                    verbose=False)
    torch.cuda.synchronize()
    log(f"[spec] encoded drafter M=24 searched and folded in "
        f"{time.perf_counter() - t0:.1f}s (U by family "
        f"{ {n: m.program.n_a_planes for n, m in dc.mac.macs.items()} }, "
        f"bundle {dinfo['bundle_bytes'] / 1e9:.3f} GB)")
    shutil.rmtree(cache)
    out = {}
    for name, k, kw in (("self", SPEC_K, {}), ("self", 8, {}),
                        ("encoded", SPEC_K, dict(draft_params=dp,
                                                 draft_cfg=dc))):
        eng, rids = _serve(params, cfg, trace, dev, spec_decode=k, **kw)
        outs, dt, counts, st = _timed_run(eng, rids)
        toks = [outs[r].tolist() for r in rids]
        n_tok = sum(map(len, toks))
        tag = f"{name} k={k}"
        log(f"[spec] {tag}: {n_tok} tokens in {dt:.3f}s = "
            f"{n_tok / dt:.1f} tok/s (captures {st['jit_compiles_by_step']})"
            f"; {st['spec_rounds']} rounds, acceptance "
            f"{st['spec_acceptance_rate']:.3f}, tokens per round "
            f"{st['spec_tokens_per_round']:.2f}; step p50 "
            f"{st['step_ms_p50']:.2f} ms p99 {st['step_ms_p99']:.2f} ms; "
            f"launches by Sq {counts['paged_attn_by_sq']}")
        same = toks == plain
        log(f"[spec] {tag}: greedy tokens against spec_decode=0: "
            f"{'identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"spec decoding ({tag}) changed the tokens")
        _check_counts(counts, st, cfg, eng.prefill_chunk, f"({tag})")
        # the trace again on the warm engine (graphs captured), then each
        # graph's replay alone on the card: a round's device time
        n0 = len(eng.step_ms)
        rids2 = [eng.submit(p, max_new=MAX_NEW) for p in trace]
        outs2, dt2, _, _ = _timed_run(eng, rids2)
        if [outs2[r].tolist() for r in rids2] != plain:
            raise AssertionError(f"spec decoding ({tag}) changed the tokens "
                                 "on the warm engine")
        warm_p50 = float(np.percentile(eng.step_ms[n0:], 50))
        replay = {}
        for step in ("draft", "verify"):
            _replay_split(eng.steps[step])
            g = eng.steps[step].graph
            s_ev, e_ev = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            s_ev.record()
            for _ in range(10):
                g.replay()
            e_ev.record()
            torch.cuda.synchronize()
            replay[step] = s_ev.elapsed_time(e_ev) / 10
        log(f"[spec] {tag}: warm engine {n_tok / dt2:.1f} tok/s, step p50 "
            f"{warm_p50:.2f} ms, tokens identical; graph replays on the card:"
            f" draft {replay['draft']:.3f} ms ({k} forwards), verify "
            f"{replay['verify']:.3f} ms")
        out[f"{name}_k{k}"] = {
            "counts": counts, "tok_s": n_tok / dt, "warm_tok_s": n_tok / dt2,
            "acceptance": st["spec_acceptance_rate"],
            "tokens_per_round": st["spec_tokens_per_round"],
            "step_p50": st["step_ms_p50"], "step_p99": st["step_ms_p99"],
            "replay": replay}
        del eng
    del dp, dc
    torch.cuda.empty_cache()
    return out


def phase_cpu_parity(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, to_device
    from repro_torch.serve import exact_encodings, prepare_encoded_serving
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              attention_backend="kernel")
    p_cpu = init_model(cfg, seed=0, device="cpu")
    cache = bundle_dir("parity")
    pe_cpu, ce, _ = prepare_encoded_serving(
        p_cpu, cfg, macs_override=exact_encodings(cfg.mac.bits),
        device="cpu", cache_dir=cache, verbose=False)
    shutil.rmtree(cache)
    pe_gpu = to_device(pe_cpu, dev)
    trace = make_trace(cfg.vocab_size)
    _code_flips(dev, pe_cpu, ce, pe_gpu, ce, trace[0], "parity")
    for mode in ("bf16", "int8", "int4"):
        cm = dataclasses.replace(ce, kv_cache_dtype=mode)
        outs = {}
        for name, params, device in (("cpu", pe_cpu, "cpu"),
                                     ("cuda", pe_gpu, dev)):
            eng, rids = _serve(params, cm, trace, device)
            _reset_counts()
            res = eng.run()
            counts = _read_counts()
            outs[name] = [res[r].tolist() for r in rids]
            log(f"[parity] reduced, kv {mode}, on {name}: "
                f"{sum(map(len, outs[name]))} tokens, launches {counts}")
            if name == "cuda":
                _check_counts(counts, eng.stats(), cm, eng.prefill_chunk,
                              "on the card")
            else:
                assert counts["encoded_matmul_by_shape"] == {} and all(
                    counts[n] == 0 for n in PATH_KERNELS + ("flash_attention",))
        same = outs["cpu"] == outs["cuda"]
        log(f"[parity] kv {mode}: greedy tokens card (kernels) vs CPU "
            f"(plain): {'identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"card and CPU greedy tokens differ (kv "
                                 f"{mode})")
    torch.cuda.empty_cache()

SEARCH_FAMILIES = ("wg", "wi", "wk", "wo", "wq", "wv")
# phase 8's searched kernel-1 rows: (family, k, n), the three decode
# shapes of full-width qwen1.5-0.5b
DECODE_SEARCH_ROWS = (("wq", 1024, 1024), ("wi", 1024, 2816),
                      ("wo", 2816, 1024))


def phase_serve_search(dev):
    """The main path with the paper's searched encodings at the serving
    CLI's defaults, searched and folded on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import encoded_matmul as em
    from repro_torch.models import apply_model, init_model
    from repro_torch.serve import prepare_encoded_serving
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              attention_backend="kernel")
    params = init_model(cfg, seed=0, device=dev)
    cache = bundle_dir("search")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # the CLI's defaults: M 48, 128 samples, 64 anneal steps, 4 batches
    params_enc, cfg_enc, info = prepare_encoded_serving(
        params, cfg, device=dev, cache_dir=cache, verbose=False)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    sec = info["seconds"]
    macs = cfg_enc.mac.macs
    assert not info["loaded"] and sorted(macs) == list(SEARCH_FAMILIES)
    assert info["n_folded"] == 7 * cfg.n_layers
    for name in SEARCH_FAMILIES:
        m = macs[name]
        arity = collections.Counter(len(t) for t in m.program.a_mono_tuples)
        log(f"[search] {name}: U={m.program.n_a_planes} (activation "
            f"monomials by bits {dict(sorted(arity.items()))}), M="
            f"{m.spec.m_bits}, weighted RMSE {m.spec.rmse:.3f}, searched in "
            f"{sec['search'][name]:.3f}s on the card")
    fw = sum(t.numel() * t.element_size() for layer in params_enc["layers"]
             for sub in layer.values() if isinstance(sub, dict)
             for k, t in sub.items() if k.endswith("_fw"))
    log(f"[search] key {sec['key']:.2f}s, calibration {sec['calibrate']:.2f}s"
        f" ({info['calib_tokens']} tokens), row weights "
        f"{sec['row_weights']:.2f}s, search {sum(sec['search'].values()):.2f}"
        f"s, fold {sec['fold']:.2f}s, bundle {info['bundle_bytes'] / 1e9:.3f}"
        f" GB written in {sec['write']:.1f}s; {total:.1f}s in all")
    log(f"[search] folded bf16 Wt {fw / 1e9:.3f} GB; device memory "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    # a second start with the same params and options: one load
    t0 = time.perf_counter()
    params_re, cfg_re, info_re = prepare_encoded_serving(
        params, cfg, device=dev, cache_dir=cache, verbose=False)
    torch.cuda.synchronize()
    reload_s = time.perf_counter() - t0
    shutil.rmtree(cache)
    assert info_re["loaded"] and info_re["bundle_dir"] == info["bundle_dir"]
    same = all(
        torch.equal(a[sub][k], b[sub][k])
        for a, b in zip(params_enc["layers"], params_re["layers"])
        for sub in ("attn", "mlp") for k in a[sub]
        if k.endswith(("_fw", "_fb", "_as", "_ws"))) and all(
        cfg_re.mac.macs[n].spec.circuit.to_json()
        == macs[n].spec.circuit.to_json() for n in SEARCH_FAMILIES)
    log(f"[search] second start: cache hit in {reload_s:.1f}s (bundle key "
        f"{info_re['seconds']['key']:.2f}s, load "
        f"{info_re['seconds']['load']:.1f}s); circuits and folded leaves "
        f"{'bit for bit the same' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("the reloaded bundle differs from the build")
    del params_re, cfg_re
    torch.cuda.empty_cache()
    # kernel 1 at each family's searched monomials and its layer-0 fold,
    # at the main path's m (decode slots, one prefill chunk).  Kernel and
    # plain version take the same bf16 Wt and differ only in f32 order, so
    # the tolerance is phase 3's, rtol 1e-4 and atol 1e-4·max|ref|: the
    # reference's kernel test (tests/test_kernel_encoded_matmul.py:36,
    # rtol = atol = 2e-2 against an f32 oracle) has an absolute floor below
    # f32 rounding here, where searched folds give outputs up to ~6e5 that
    # pass near 0 (first card run: max error 0.44, 7.5e-7 of max|ref|)
    g = torch.Generator().manual_seed(3)
    layer = params_enc["layers"][0]
    for sub, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                      ("attn", "wo"), ("mlp", "wg"), ("mlp", "wi"),
                      ("mlp", "wo")):
        wt, bias = layer[sub][name + "_fw"], layer[sub][name + "_fb"]
        U, k, n = wt.shape
        shifts = macs[name].program.a_mono_bits
        for m in (N_SLOTS, 32):
            x = torch.randint(-127, 128, (m, k), generator=g,
                              dtype=torch.int8).to(dev)
            out = em.encoded_matmul(x, wt, bias, shifts)
            ref = em.encoded_matmul_plain(x, wt, bias, shifts)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            top = ref.abs().max().item()
            ok = torch.allclose(out, ref, rtol=1e-4, atol=1e-4 * top)
            log(f"[search-kernel1] {sub}/{name} U={U} m={m} k={k} n={n}: "
                f"max_abs_err {err:.3e} = {err / top:.2e} of max|ref| "
                f"{top:.3e} (rtol 1e-4, atol 1e-4·max|ref|) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel 1 disagrees with its plain "
                                     f"version at {sub}/{name} m={m}")
    trace = make_trace(cfg.vocab_size)
    warm, _ = _serve(params_enc, cfg_enc, trace[:1], dev)
    warm.run()
    del warm
    eng, rids = _serve(params_enc, cfg_enc, trace, dev)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_counts()
    st = eng.stats()
    n_tok = sum(len(outs[r]) for r in rids)
    log(f"[serve-search] {len(outs)} requests, {n_tok} tokens in {dt:.3f}s "
        f"= {n_tok / dt:.1f} tok/s; decode steps {st['decode_steps']}, "
        f"prefill chunks {st['prefill_chunks']}, step p50 "
        f"{st['step_ms_p50']:.2f} ms p99 {st['step_ms_p99']:.2f} ms")
    log(f"[serve-search] launches: encoded_matmul {counts['encoded_matmul']}"
        f" paged_attn {counts['paged_attn']} flash_attention "
        f"{counts['flash_attention']}; by (m, k, n) "
        f"{counts['encoded_matmul_by_shape']}")
    assert len(outs) == N_REQUESTS and all(
        len(outs[r]) == MAX_NEW for r in rids), "not every request finished"
    assert all(0 <= t < cfg.vocab_size for r in rids for t in outs[r])
    _check_counts(counts, st, cfg, eng.prefill_chunk, "on the searched path")
    toks = torch.from_numpy(trace[0][:16])[None].to(dev)
    with torch.inference_mode():
        lg_enc, _ = apply_model(params_enc, cfg_enc, toks)
        lg_fp, _ = apply_model(params, cfg, toks)
    assert lg_enc.shape == (1, 16, cfg.vocab_p)
    assert bool(torch.isfinite(lg_enc).all()), "non-finite logits"
    agree = (lg_enc.argmax(-1) == lg_fp.argmax(-1)).float().mean().item()
    log(f"[serve-search] full-width searched-encoding vs fp logits: top-1 "
        f"agreement {agree:.3f} (random weights; printed, not gated)")
    split = step_split(dev, params_enc, cfg_enc, trace)
    programs = {name: macs[name].program for name, _, _ in
                DECODE_SEARCH_ROWS}
    del params_enc, params, eng
    torch.cuda.empty_cache()
    return {"counts": counts, "steps": st["decode_steps"],
            "chunks": st["prefill_chunks"], "tok_s": n_tok / dt,
            "programs": programs, "split": split}


TIE_RTOL = 1e-6


def _check_near_tie(dev, params, cfg, names, name, opts):
    """Where the card and the CPU searched different circuits for family
    ``name``: each side's row weights (its own calibration), the same
    random-search result, and the anneal replayed along the card's choices
    must part at a step whose candidates lie within ``TIE_RTOL`` of each
    other under both fits (a near-tie at f32 rounding, ROADMAP Queue C);
    anything else raises."""
    from repro_torch.core import gates
    from repro_torch.core.encoding import fit_position_weights
    from repro_torch.core.search import anneal_choices_apart, random_search
    from repro_torch.models import to_device
    from repro_torch.serve.encoded import (capture_activation_stats,
                                           family_row_weights)
    i = names.index(name)
    rw, starts = {}, {}
    for d in (dev, "cpu"):
        p = to_device(params, d)
        st = capture_activation_stats(p, cfg)
        rw[str(d)] = family_row_weights(p, st, cfg.mac.bits)[name]
        starts[str(d)] = random_search(
            101 * i, 48, opts["n_samples"], row_weights=rw[str(d)],
            patience=opts["n_samples"], device=d)
    g, c = starts[str(dev)].spec, starts["cpu"].spec
    log(f"[parity-search] {name}: row weights card vs CPU max |diff| "
        f"{float(abs(rw[str(dev)] - rw['cpu']).max()):.3e}; random search "
        f"RMSE card {g.rmse:.6f} CPU {c.rmse:.6f}")
    if not (g.circuit.to_json() == c.circuit.to_json()):
        raise AssertionError(f"{name}: the random search already differs")
    vals = gates.signed_products(8, 8)
    apart = anneal_choices_apart(
        g, 101 * i + 7919, opts["refine"],
        lambda gt, ii: fit_position_weights(gt, ii, vals,
                                            row_weights=rw[str(dev)],
                                            device=dev)[1],
        lambda gt, ii: fit_position_weights(gt, ii, vals,
                                            row_weights=rw["cpu"],
                                            device="cpu")[1])
    log(f"[parity-search] {name}: anneal replayed along the card's choices:"
        f" parts at (step, spread card, spread CPU) = {apart} (near-tie "
        f"below {TIE_RTOL})")
    if apart is None or max(apart[1:]) > TIE_RTOL:
        raise AssertionError(f"the card and the CPU searched different "
                             f"circuits for {name}, not at a near-tie")


def phase_cpu_parity_search(dev):
    """Reduced config: the search on the card and on the CPU choose the
    same circuits; the CPU serves from the card's bundle (a cache hit)
    with the plain versions and gives the card's greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.serve import prepare_encoded_serving
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              attention_backend="kernel")
    p_cpu = init_model(cfg, seed=0, device="cpu")
    # the CLI's 128 + 64 fits per family would take minutes on the host
    opts = dict(n_samples=16, refine=8, verbose=False)
    card_dir, cpu_dir = bundle_dir("parity-search"), bundle_dir("parity-cpu")
    try:
        t0 = time.perf_counter()
        pe_g, ce_g, info_g = prepare_encoded_serving(
            p_cpu, cfg, device=dev, cache_dir=card_dir, **opts)
        t1 = time.perf_counter()
        _, ce_c, info_c = prepare_encoded_serving(
            p_cpu, cfg, device="cpu", cache_dir=cpu_dir, **opts)
        t2 = time.perf_counter()
        log(f"[parity-search] reduced, 16 samples + 8 anneal steps per "
            f"family: built on the card in {t1 - t0:.1f}s, on the CPU in "
            f"{t2 - t1:.1f}s")
        for name in sorted(ce_g.mac.macs):
            g, c = ce_g.mac.macs[name].spec, ce_c.mac.macs[name].spec
            same = (np.array_equal(g.circuit.gate_types, c.circuit.gate_types)
                    and np.array_equal(g.circuit.in_idx, c.circuit.in_idx))
            log(f"[parity-search] {name}: U={ce_g.mac.macs[name].program.n_a_planes}"
                f" RMSE card {g.rmse:.6f} CPU {c.rmse:.6f}: circuits "
                f"{'the same' if same else 'DIFFERENT'}")
            if not same:
                _check_near_tie(dev, p_cpu, cfg, sorted(ce_g.mac.macs), name,
                                opts)
        pe_c, ce_c, info_c = prepare_encoded_serving(
            p_cpu, cfg, device="cpu", cache_dir=card_dir, **opts)
        assert info_c["loaded"] and info_c["bundle_dir"] == \
            info_g["bundle_dir"], "the card's bundle was not a cache hit"
        log(f"[parity-search] the CPU loaded the card's bundle "
            f"{os.path.basename(info_g['bundle_dir'])}")
    finally:
        shutil.rmtree(card_dir)
        shutil.rmtree(cpu_dir)
    trace = make_trace(cfg.vocab_size)
    _linears_teacher_forced(dev, pe_c, ce_c, pe_g, ce_g, trace[0])
    _code_flips(dev, pe_c, ce_c, pe_g, ce_g, trace[0], "parity-search")
    outs = {}
    for name, params, cm, device in (("cpu", pe_c, ce_c, "cpu"),
                                     ("cuda", pe_g, ce_g, dev)):
        eng, rids = _serve(params, cm, trace, device)
        _reset_counts()
        res = eng.run()
        counts = _read_counts()
        outs[name] = [res[r].tolist() for r in rids]
        log(f"[parity-search] on {name}: {sum(map(len, outs[name]))} tokens,"
            f" launches {counts}")
        assert len(res) == N_REQUESTS and all(
            len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size for x in t)
            for t in outs[name]), f"not every request finished on {name}"
        if name == "cuda":
            _check_counts(counts, eng.stats(), cm, eng.prefill_chunk,
                          "on the card")
        else:
            assert counts["encoded_matmul_by_shape"] == {} and all(
                counts[n] == 0 for n in PATH_KERNELS + ("flash_attention",))
    # printed, not gated: with an approximate product table one activation
    # code on the other side of a rounding boundary (f32 summation order)
    # moves a linear's output by a table error, so greedy tokens part
    # after the first such code (ROADMAP Queue C); phase 7 gates the exact
    # encoding's tokens and the check above each searched linear
    same = [a == b for a, b in zip(outs["cpu"], outs["cuda"])]
    first = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
             for a, b in zip(outs["cpu"], outs["cuda"])]
    log(f"[parity-search] greedy tokens card (kernels) vs CPU (plain), "
        f"searched encodings: {sum(same)} of {len(same)} requests "
        f"identical; first differing token per request {first}")
    torch.cuda.empty_cache()


def _code_flips(dev, pe_c, ce_c, pe_g, ce_g, prompt, tag):
    """Log, for one forward of ``prompt`` on the CPU and on the card, how
    far apart each encoded linear's input is and how many of its int8
    activation codes differ (a diagnosis, not a gate)."""
    import torch
    from repro_torch.models import apply_model
    from repro_torch.nn.common import activation_recorder
    xs = {}
    for name, pe, ce, d in (("cpu", pe_c, ce_c, "cpu"),
                            ("cuda", pe_g, ce_g, dev)):
        sites = {id(t): (li, sub, k, layer[sub][k + "_as"])
                 for li, layer in enumerate(pe["layers"])
                 for sub in ("attn", "mlp") for k, t in layer[sub].items()
                 if k + "_fw" in layer[sub]}
        calls = []
        with torch.inference_mode(), activation_recorder(
                lambda n, w, x: calls.append((sites[id(w)],
                                              x.float().cpu()))):
            apply_model(pe, ce, torch.from_numpy(prompt)[None].to(d))
        xs[name] = calls
    flips, rel, first = [], [], None
    for ((li, sub, k, sa), xc), (_, xg) in zip(xs["cpu"], xs["cuda"]):
        sa = sa.cpu()
        qc, qg = (torch.clamp(torch.round(x / sa), -127, 127)
                  for x in (xc, xg))
        n = int((qc != qg).sum())
        flips.append(n)
        rel.append((xc - xg).abs().max().item() / xc.abs().max().item())
        if n and first is None:
            q = (xc / sa)[qc != qg]
            first = (f"layer {li} {sub}/{k}, x / scale "
                     f"{((q - q.floor()) - 0.5).abs().min().item():.2e} "
                     f"from a .5 boundary")
    log(f"[{tag}] one {len(prompt)}-token forward, card vs CPU: encoded "
        f"linears' inputs apart by at most {[f'{r:.1e}' for r in rel]} "
        f"(max |diff| / max |x|); int8 codes that differ per linear "
        f"{flips}; first: {first}")


def _linears_teacher_forced(dev, pe_c, ce_c, pe_g, ce_g, prompt):
    """Every encoded linear of one CPU forward of ``prompt``, run again on
    the card (kernel 1) from the CPU's input: within f32 tolerance
    (rtol 1e-4, atol 1e-4·max|out|) of the CPU's output (plain version)."""
    import torch
    from repro_torch.models import apply_model
    from repro_torch.nn.common import activation_recorder
    sites = {id(t): (li, sub, k) for li, layer in enumerate(pe_c["layers"])
             for sub in ("attn", "mlp") for k, t in layer[sub].items()
             if k + "_fw" in layer[sub]}
    calls = []
    with torch.inference_mode(), activation_recorder(
            lambda n, w, x: calls.append((sites[id(w)], x.clone()))):
        apply_model(pe_c, ce_c, torch.from_numpy(prompt)[None])
    ex = ce_c.mac.executor
    worst = 0.0
    with torch.inference_mode():
        for (li, sub, k), x in calls:
            yc = ex.apply(pe_c["layers"][li][sub], k, x, ce_c.mac, ce_c.cdtype)
            yg = ex.apply(pe_g["layers"][li][sub], k, x.to(dev), ce_g.mac,
                          ce_g.cdtype).cpu()
            top = yc.abs().max().item()
            err = (yg - yc).abs().max().item()
            worst = max(worst, err / top)
            if not torch.allclose(yg, yc, rtol=1e-4, atol=1e-4 * top):
                raise AssertionError(f"layer {li} {sub}/{k}: card and CPU "
                                     f"outputs differ by {err:.3e} (max "
                                     f"{top:.3e}) from the same input")
    log(f"[parity-search] {len(calls)} encoded linears of one forward "
        f"({len(prompt)} tokens), each on the card from the CPU's input: "
        f"within rtol 1e-4, atol 1e-4·max|out| (worst max err / max|out| "
        f"{worst:.2e})")


def _em_row(dev, prog, m, k, n, seed, name, launches, shape, lib):
    """Kernel 1's row of the kernels line: ``prog``'s monomials at (m, k,
    n), kernel and plain version timed over 4 input sets, and the library
    yardstick: the same function as one bf16 product of the 0/1 planes
    (m, U·k) by Wt (U·k, n), f32 out (the bias add left out)."""
    import torch
    from repro_torch.kernels import encoded_matmul as em
    from repro_torch.kernels.ref import planes_ref
    from repro_torch.launch.kernel_bench import time_graph
    U = prog.n_a_planes
    sets = _em_case(dev, prog, m, k, n, seed=seed, copies=4)
    out, ref = em.encoded_matmul(*sets[0]), em.encoded_matmul_plain(*sets[0])
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=1e-4,
                          atol=1e-4 * ref.abs().max().item()):
        raise AssertionError(f"{name}: kernel 1 disagrees with plain "
                             f"(max abs err {err:.3e})")
    ms = time_graph(em.encoded_matmul, sets)
    plain_ms = time_loop(em.encoded_matmul_plain, sets)
    lib_sets = [(planes_ref(x, sh).to(torch.bfloat16).permute(1, 0, 2)
                 .reshape(m, U * k).contiguous(), wt.reshape(U * k, n))
                for x, wt, _, sh in sets]
    lib_ms = time_graph(lib[0], lib_sets)
    nbytes = m * k + U * k * n * 2 + n * 4 + m * n * 4
    ops = 2.0 * m * k * n * U
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    log(f"[measure] {name}: {U * k * n * 2 / (ms * 1e-3) / 1e12:.3f} TB/s "
        f"of Wt")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/encoded_matmul.cu",
            "replaces": "src/repro/kernels/encoded_matmul.py:50",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib_ms,
            "shape": f"m={m} k={k} n={n} U={U} ({shape}); library: "
                     f"{lib[1]} over K = U·k"}


def phase_measure(dev, serve_info):
    """Kernel, plain and library times at the main path's shapes."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.kernel_bench import bf16_mm, time_graph
    rows = []
    lib = bf16_mm()
    shapes = ((1024, 1024), (1024, 2816), (2816, 1024))
    # kernel 1 at the main path's six shapes: the linears (k, n) = (1024,
    # 1024) x 4, (1024, 2816) x 2 and (2816, 1024) x 1 per layer, at decode
    # (m = n_slots) and at prefill (m = one 32-token chunk); launches are
    # the dense serve's at that shape
    prog = _program("exact")
    by_shape = serve_info["counts"]["encoded_matmul_by_shape"]
    for m in (N_SLOTS, 32):
        for k, n in shapes:
            rows.append(_em_row(
                dev, prog, m, k, n, 1, f"encoded_matmul_m{m}_k{k}_n{n}",
                by_shape.get((m, k, n), 0),
                "decode" if m == N_SLOTS else "prefill", lib))
    # kernel 1 at speculative verification's shapes, m = n_slots·(k+1):
    # 20 at k = 4 and 36 at k = 8, exact U; launches are the self-drafter
    # serve's with that k
    for sk in (SPEC_K, 8):
        m = N_SLOTS * (sk + 1)
        v_shape = serve_info["spec"][f"self_k{sk}"]["counts"][
            "encoded_matmul_by_shape"]
        for k, n in shapes:
            rows.append(_em_row(
                dev, prog, m, k, n, 3, f"encoded_matmul_m{m}_k{k}_n{n}",
                v_shape.get((m, k, n), 0), f"speculative verify, k={sk}",
                lib))
    # kernel 1 at the searched U of phase 6b, at its three decode shapes:
    # (k, n) of wq, wi and the MLP's wo with that family's monomials
    search = serve_info["search"]
    s_shape = search["counts"]["encoded_matmul_by_shape"]
    for name, k, n in DECODE_SEARCH_ROWS:
        prog = search["programs"][name]
        monos = collections.Counter(len(t) for t in prog.a_mono_tuples)
        rows.append(_em_row(
            dev, prog, N_SLOTS, k, n, 2,
            f"encoded_matmul_search_{name}_m{N_SLOTS}_k{k}_n{n}",
            s_shape.get((N_SLOTS, k, n), 0),
            f"decode, searched {name}: monomials by bits "
            f"{dict(sorted(monos.items()))}; launches: every family at "
            f"this (m, k, n) in the searched serve", lib))
    # kernel 2: decode attention, 4 slots × 16 heads × D 64, with dense
    # f32, int8 and packed-int4 pools, at a 32-page table and at the
    # serve's 127-page table (the same lens, so the same bytes); then at
    # speculative verification's Sq = k+1 (5 and 9) with dense f32 pools
    # and the serve's table, launches those at that Sq in the self-drafter
    # serves with k = 4 and 8.  The floor is an empty kernel on the same
    # grid and cluster, replayed the same way
    B, H, D, ps = N_SLOTS, 16, 64, PAGE_SIZE
    lens = [100, 200, 300, 400]
    cases = [(mode, P, 1) for mode in ("bf16", "int8", "int4")
             for P in (32, SERVE_P)]
    cases += [("bf16", SERVE_P, SPEC_K + 1), ("bf16", SERVE_P, 9)]
    for mode, P, sq in cases:
        if mode == "bf16":
            sets, kv_map = _pa_case(dev, B, sq, H, H, D, ps, P, lens,
                                    torch.float32, seed=5 if sq == 1 else 7,
                                    copies=8)
            args = [a + (None, None) for a in sets]
        else:
            qsets, kv_map = _pa_quant_case(dev, mode, B, sq, H, H, D, ps,
                                           P, lens, seed=6, copies=8)
            args = [a + sc for a, sc in qsets]

        def kern(q, pk, pv, pg, ln, sk, sv):
            return pa.paged_attn(q, pk, pv, pg, ln, scale=D ** -0.5,
                                 kv_of_q=kv_map, scale_k=sk, scale_v=sv)

        def plain(q, pk, pv, pg, ln, sk, sv):
            return pa.paged_attn_plain(q, pk, pv, pg, ln, pa._NO_WINDOW,
                                       scale=D ** -0.5, G=1, scale_k=sk,
                                       scale_v=sv)

        err = (kern(*args[0]) - plain(*args[0])).abs().max().item()
        ms = time_graph(kern, args)
        plain_ms = time_loop(plain, args)
        floor_ms = time_graph(
            lambda: pa.paged_attn_floor(B, H, P, dev), [()] * 8)
        read = sum((l_ + sq - 1) // ps + 1 for l_ in lens)  # per kv head
        row_bytes = D * 4 if mode == "bf16" else (
            D // 2 + 4 if mode == "int4" else D + 4)
        nbytes = (2 * B * sq * H * D * 4 + 2 * read * ps * H * row_bytes
                  + read * 4 + B * 4)
        ops = 4.0 * sq * D * read * ps * H
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        if sq == 1:
            name = "paged_attn" + ("" if mode == "bf16" else f"_{mode}") + (
                "" if P == 32 else f"_p{P}")
            note = ("f32 pools" if mode == "bf16"
                    else f"{mode} pools + f32 scales")
            launches = (serve_info["counts"] if mode == "bf16"
                        else serve_info[mode]["counts"])["paged_attn"]
        else:
            name = f"paged_attn_sq{sq}_p{P}"
            note = f"f32 pools (speculative verify, k={sq - 1})"
            launches = serve_info["spec"][f"self_k{sq - 1}"]["counts"][
                "paged_attn_by_sq"].get(sq, 0)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:131",
            "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            # no PyTorch call reads K/V through a page table
            "library_ms": None,
            "floor_ms": floor_ms,
            "cluster": pa.cluster_size(B, H, P, torch.cuda.
                                       get_device_properties(dev)
                                       .multi_processor_count),
            "shape": f"B={B} Sq={sq} H={H} D={D} ps={ps} P={P} "
                     f"lens={lens} {note}, {nbytes / 1e6:.3f} MB"})
    # kernel 3 at the prefill shape of full-width qwen1.5-0.5b: B 4, S 1024,
    # 16 heads, D 64, causal; flattened (B·H, S, D) as flash_mha hands it
    # to the kernel.  Not on the serving path: launches 0 (the reference's
    # model never reaches its flash kernel either).
    from repro_torch.kernels import flash_attention as fa
    Bf, S, Hf, Df = 4, 1024, 16, 64
    # f32 runs 3xTF32: three tf32 products per product on the tensor cores
    for dt, tag, peak, n_mma in ((torch.float32, "f32", PEAK_TF32, 3),
                                 (torch.bfloat16, "bf16", PEAK_BF16, 1)):
        fsets = []
        for i in range(3):
            q, k, v = _flash_case(dev, Bf, S, Hf, Hf, Df, dt, seed=20 + i)
            flat = [t.permute(0, 2, 1, 3).reshape(Bf * Hf, S, Df).contiguous()
                    for t in (q, k, v)]
            fsets.append(flat)
        kw = dict(scale=Df ** -0.5)
        kern = lambda q, k, v: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        plain = lambda q, k, v: fa.flash_attention_plain(  # noqa: E731
            q, k, v, **kw)
        err = (kern(*fsets[0]).float()
               - plain(*fsets[0]).float()).abs().max().item()
        ms = time_graph(kern, fsets, iters=20)
        plain_ms = time_loop(plain, fsets, iters=5)
        lib_sets = [[t.reshape(Bf, Hf, S, Df) for t in f] for f in fsets]
        sdpa = functools.partial(
            torch.nn.functional.scaled_dot_product_attention, is_causal=True,
            scale=Df ** -0.5)
        lib_ms = time_graph(sdpa, lib_sets, iters=20)
        nbytes = 4 * Bf * Hf * S * Df * (4 if dt == torch.float32 else 2)
        ops_f = 4.0 * Df * Bf * Hf * S * (S + 1) / 2   # visible pairs only
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, n_mma * ops_f / peak * 1e3
        rows.append({
            "name": f"flash_attention_{tag}", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:24",
            "launches": serve_info["counts"]["flash_attention"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib_ms,
            "shape": f"B={Bf} S={S} H={Hf} D={Df} causal {tag}, "
                     f"{fa.flash_route(dt, Df)} kernel (prefill; not on the "
                     "serving path)" + (
                         f"; f32-pipe bound {ops_f / PEAK_F32 * 1e3:.4f} ms"
                         if dt == torch.float32 else "")})
    for r in rows:
        floor = (f", floor {r['floor_ms']:.4f} ms (cluster {r['cluster']})"
                 if "floor_ms" in r else "")
        log(f"[measure] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){floor}, "
            f"launches on the main path {r['launches']}")
    per_step = serve_info["steps"] + serve_info["chunks"] + 2
    log(f"[measure] launches per engine forward (decode steps + prefill "
        f"chunks + the 2 graph warm-ups = {per_step}): encoded_matmul "
        f"{serve_info['counts']['encoded_matmul'] / per_step:.1f}, "
        f"paged_attn per decode forward "
        f"{serve_info['counts']['paged_attn'] / (serve_info['steps'] + 1):.1f}"
        f"; flash_attention {serve_info['counts']['flash_attention']} (not "
        "on the serving path)")
    return rows


def main() -> int:
    t_start = time.perf_counter()
    dev = card_check()
    import torch
    phase_build()
    phase_kernel1(dev)
    phase_kernel2(dev)
    phase_kernel2_quant(dev)
    phase_flash(dev)
    serve_info = phase_serve(dev)
    serve_info.update(phase_serve_quant(dev, serve_info))
    serve_info["prefix"] = phase_prefix(dev, serve_info)
    serve_info["spec"] = phase_spec(dev, serve_info)
    for key in ("params", "cfg", "params_enc", "cfg_enc", "trace", "tokens",
                "stats"):
        del serve_info[key]
    torch.cuda.empty_cache()
    serve_info["search"] = phase_serve_search(dev)
    phase_cpu_parity(dev)
    phase_cpu_parity_search(dev)
    rows = phase_measure(dev, serve_info)
    for r in rows:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if not math.isfinite(r[key]):
                raise AssertionError(f"{r['name']}: {key} is not finite")
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
