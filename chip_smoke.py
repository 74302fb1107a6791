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
    3-bit monomials and ragged shapes;
 4. kernel 2 (paged attention) against its plain version: ragged lens
    including 0 and page boundaries, f32 and bf16 pools, GQA, window +
    softcap, Sq = 3; then the same with int8 and packed-int4 pools (and
    the quantizer's codes and scales on the card against the CPU's, bit
    for bit), at the main path's decode shape too;
 5. kernel 3 (flash attention) through ``ops.flash_mha`` against its plain
    version: the prefill shape of full-width qwen1.5-0.5b in f32 and bf16,
    ragged S = 100, GQA, window, softcap;
 6. the main path: qwen1.5-0.5b at full width and depth (weights from seed
    0), calibrated encoded-MAC serving with the exact AND-plane encoding
    and the fused paged-attention kernel, continuous batching of 8
    requests over 4 slots, first with dense (f32) KV pools, then, from
    the same fold, with int8 and with int4 pools; the kernels' launch
    counts are set to 0 just before each run and read just after.  After
    the dense run one decode step with every slot busy is timed on the
    host clock and, as a measurement only, its forward replayed from a
    CUDA graph (the card's time without the host's);
 7. the reduced config and the same trace served on the card (kernels)
    and on the CPU (plain versions), with dense, int8 and int4 pools:
    identical greedy tokens;
 8. per-kernel times at the main path's shapes beside their bound, the
    plain version's time and a library call's, as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12

N_REQUESTS, MAX_NEW = 8, 32
N_SLOTS, PAGE_SIZE, N_PAGES = 4, 16, 256


def log(msg: str) -> None:
    print(msg, flush=True)


def make_trace(vocab: int, seed: int = 0):
    """8 prompts of 16–256 tokens from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lens = rng.integers(16, 257, N_REQUESTS)
    return [rng.integers(0, vocab, int(n)).astype(np.int32) for n in lens]


def time_graph(fn, arg_sets, iters: int = 40) -> float:
    """ms per call of ``fn`` replayed from one CUDA graph of ``iters``
    calls that rotate over ``arg_sets`` (sized past the 50 MB L2, so every
    call reads cold data as the serving loop does)."""
    import torch
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    g.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    s.record()
    g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


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
    cases += [("sampled48", sampled, 4, 1024, 2816),
              ("sampled48", sampled, 32, 2816, 1024),
              ("ragged", exact, 100, 130, 70),
              ("ragged", sampled, 5, 77, 33)]
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


def phase_kernel2(dev):
    import torch
    from repro_torch.kernels import paged_attention as pa
    ps, D, P = 16, 64, 32
    lens = [0, 16, 17, 511]
    cases = [("mha-f32", 1, 16, 16, None, None, torch.float32),
             ("mha-bf16", 1, 16, 16, None, None, torch.bfloat16),
             ("gqa-f32", 1, 16, 4, None, None, torch.float32),
             ("win+cap", 1, 16, 4, 100, 30.0, torch.float32),
             ("sq3-gqa", 3, 16, 4, None, None, torch.float32)]
    for tag, Sq, Hq, Hkv, window, cap, dtype in cases:
        ln = [min(x, P * ps - Sq) for x in lens]
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
        log(f"[kernel2] {tag:8s} B=4 Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} "
            f"ps={ps} lens={ln} max_abs_err={err:.3e} {tol} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel2 disagrees with plain at {tag}")


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
    ps, D, P = 16, 64, 32
    lens = [0, 16, 17, 511]
    cases = [("mha", 1, 16, 16, None, None, lens),
             ("gqa", 1, 4, 2, None, None, lens),
             ("win+cap", 1, 16, 4, 100, 30.0, lens),
             ("sq3-gqa", 3, 4, 2, None, None, lens),
             ("decode", 1, 16, 16, None, None, [100, 200, 300, 400])]
    # the f32 sums run in another order on the card (and exp differs by
    # ulps): the dense kernel's f32 tolerance, not the CPU tests' 2e-5
    tol = dict(rtol=1e-4, atol=1e-5)
    for mode in ("int8", "int4"):
        for tag, Sq, Hq, Hkv, window, cap, ln in cases:
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
                f"D={D} ps={ps} lens={ln} max_abs_err={err:.3e} {tol} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel2 {mode} disagrees with plain "
                                     f"at {tag}")


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
             ("win+cap-bf16", 2, 256, 4, 2, 128, 32, 20.0, torch.bfloat16)]
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
            f"window={window} cap={cap} max_abs_err={err:.3e} (tol {tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with plain at "
                                 f"{tag}")


def _serve(params, cfg, trace, device, max_new: int = MAX_NEW):
    from repro_torch.serve import Engine
    eng = Engine(params, cfg, n_slots=N_SLOTS, page_size=PAGE_SIZE,
                 n_pages=N_PAGES, device=device)
    rids = [eng.submit(p, max_new=max_new) for p in trace]
    return eng, rids


def _reset_counts():
    from repro_torch.kernels import encoded_matmul as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    em.encoded_matmul.launches = 0
    pa.paged_attn.launches = 0
    fa.flash_attention.launches = 0


def _read_counts():
    from repro_torch.kernels import encoded_matmul as em
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    return {"encoded_matmul": em.encoded_matmul.launches,
            "paged_attn": pa.paged_attn.launches,
            "flash_attention": fa.flash_attention.launches}


# the serving path's kernels; flash attention is not on it (the reference
# never routes its model through the flash kernel, and the port mirrors
# that), so its count must stay 0 there
PATH_KERNELS = ("encoded_matmul", "paged_attn")


def _check_counts(counts, decode_steps, n_layers, where):
    """Every kernel of the path launched, paged attention once per layer
    per decode step (prefill chunks take the gather path), flash never."""
    for name in PATH_KERNELS:
        assert counts[name] > 0, f"{name} was not launched {where}"
    assert counts["paged_attn"] == n_layers * decode_steps, \
        f"paged_attn launched {counts['paged_attn']} times {where}, not " \
        f"{n_layers} per decode step x {decode_steps}"
    assert counts["flash_attention"] == 0, f"flash launched {where}"


def phase_serve(dev):
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
    t0 = time.perf_counter()
    params_enc, cfg_enc, info = prepare_encoded_serving(
        params, cfg, macs_override=exact_encodings(cfg.mac.bits),
        device=dev)
    torch.cuda.synchronize()
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
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_counts()
    st = eng.stats()
    n_tok = sum(len(outs[r]) for r in rids)
    log(f"[serve] prompts {[len(p) for p in trace]} max_new={MAX_NEW} "
        f"slots={N_SLOTS} ps={PAGE_SIZE} pages={N_PAGES}")
    log(f"[serve] {len(outs)} requests, {n_tok} tokens in {dt:.3f}s = "
        f"{n_tok / dt:.1f} tok/s; decode steps {st['decode_steps']}, "
        f"prefill chunks {st['prefill_chunks']}, step p50 "
        f"{st['step_ms_p50']:.2f} ms p99 {st['step_ms_p99']:.2f} ms, "
        f"kv pool {st['kv_pool_bytes'] / 1e9:.3f} GB")
    log(f"[serve] launches: encoded_matmul {counts['encoded_matmul']} "
        f"paged_attn {counts['paged_attn']} flash_attention "
        f"{counts['flash_attention']}")
    assert len(outs) == N_REQUESTS and all(
        len(outs[r]) == MAX_NEW for r in rids), "not every request finished"
    assert all(0 <= t < cfg.vocab_size for r in rids for t in outs[r])
    _check_counts(counts, st["decode_steps"], cfg.n_layers,
                  "on the main path")
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
    step_split(dev, params_enc, cfg_enc, trace)
    del params
    return {"counts": counts, "steps": st["decode_steps"],
            "chunks": st["prefill_chunks"], "tok_s": n_tok / dt,
            "params_enc": params_enc, "cfg_enc": cfg_enc, "trace": trace,
            "tokens": [outs[r].tolist() for r in rids], "stats": st}


def phase_serve_quant(dev, dense):
    """The main path again with int8, then int4 KV pools, from the dense
    run's fold (calibration does not depend on the KV dtype)."""
    import torch
    params, cfg0, trace = (dense["params_enc"], dense["cfg_enc"],
                           dense["trace"])
    st0 = dense["stats"]
    out = {}
    for mode in ("int8", "int4"):
        cfg = dataclasses.replace(cfg0, kv_cache_dtype=mode)
        eng, rids = _serve(params, cfg, trace, dev)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = _read_counts()
        st = eng.stats()
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
            f"({counts['paged_attn'] / st['decode_steps']:.1f} per decode "
            f"step) flash_attention {counts['flash_attention']}")
        log(f"[serve-{mode}] greedy tokens equal to the dense-pool run's: "
            f"{same} of {n_tok} ({same / n_tok:.3f}; printed, not gated: "
            "quantized KV is not expected to give identical tokens)")
        assert len(res) == N_REQUESTS and all(
            len(t) == MAX_NEW for t in toks), "not every request finished"
        assert all(0 <= t < cfg.vocab_size for x in toks for t in x)
        _check_counts(counts, st["decode_steps"], cfg.n_layers,
                      f"with {mode} pools")
        out[mode] = {"counts": counts, "steps": st["decode_steps"],
                     "tok_s": n_tok / dt}
        del eng
    torch.cuda.empty_cache()
    return out


def step_split(dev, params, cfg, trace, steps: int = 10):
    """Host against device time of one full-width decode step with every
    slot decoding: the engine's step on the host clock, and the same
    forward replayed from a CUDA graph, which leaves out the host's time
    between launches (the graph is a measurement only; the engine does not
    use one)."""
    import torch
    from repro_torch.models import apply_model
    eng, _ = _serve(params, cfg, trace[:N_SLOTS], dev, max_new=4 * MAX_NEW)
    while eng.counters["prefills"] < N_SLOTS:
        eng.step()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    toks = torch.zeros((N_SLOTS, 1), dtype=torch.int32, device=dev)
    cache = {"layers": eng.kv.layers, "pages": eng.kv.pages_dev(),
             "lens": eng.kv.lens_dev()}
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            apply_model(params, cfg, toks, cache=cache)
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            apply_model(params, cfg, toks, cache=cache)
        g.replay()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        s.record()
        for _ in range(steps):
            g.replay()
        e.record()
        torch.cuda.synchronize()
    dev_ms = s.elapsed_time(e) / steps
    log(f"[step] {N_SLOTS} slots decoding: engine step {host_ms:.3f} ms on "
        f"the host clock; the same forward from a CUDA graph "
        f"{dev_ms:.3f} ms on the card; device busy share about "
        f"{dev_ms / host_ms:.3f}")
    del g, eng


def phase_cpu_parity(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model, to_device
    from repro_torch.serve import exact_encodings, prepare_encoded_serving
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              attention_backend="kernel")
    p_cpu = init_model(cfg, seed=0, device="cpu")
    pe_cpu, ce, _ = prepare_encoded_serving(
        p_cpu, cfg, macs_override=exact_encodings(cfg.mac.bits),
        device="cpu")
    pe_gpu = to_device(pe_cpu, dev)
    trace = make_trace(cfg.vocab_size)
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
                _check_counts(counts, eng.counters["decode_steps"],
                              cm.n_layers, "on the card")
            else:
                assert all(n == 0 for n in counts.values())
        same = outs["cpu"] == outs["cuda"]
        log(f"[parity] kv {mode}: greedy tokens card (kernels) vs CPU "
            f"(plain): {'identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"card and CPU greedy tokens differ (kv "
                                 f"{mode})")
    torch.cuda.empty_cache()


def phase_measure(dev, serve_info):
    """Kernel, plain and library times at the main path's decode shape."""
    import torch
    from repro_torch.kernels import encoded_matmul as em
    from repro_torch.kernels import paged_attention as pa
    rows = []
    # kernel 1: decode wi of qwen1.5-0.5b — m = n_slots, k = 1024, n = 2816
    prog = _program("exact")
    m, k, n, U = N_SLOTS, 1024, 2816, prog.n_a_planes
    sets = _em_case(dev, prog, m, k, n, seed=1, copies=4)
    err = (em.encoded_matmul(*sets[0])
           - em.encoded_matmul_plain(*sets[0])).abs().max().item()
    ms = time_graph(em.encoded_matmul, sets)
    plain_ms = time_loop(em.encoded_matmul_plain, sets)
    lib_sets = []
    for x, wt, bias, shifts in sets[:3]:
        from repro_torch.kernels.ref import planes_ref
        a = planes_ref(x, shifts).float().permute(1, 0, 2).reshape(m, U * k)
        lib_sets.append((a.contiguous(), wt.float().reshape(U * k, n)))
    lib_ms = time_graph(torch.matmul, lib_sets)
    nbytes = m * k + U * k * n * 2 + n * 4 + m * n * 4
    ops = 2.0 * m * k * n * U
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
    rows.append({
        "name": "encoded_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/encoded_matmul.cu",
        "replaces": "src/repro/kernels/encoded_matmul.py:50",
        "launches": serve_info["counts"]["encoded_matmul"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": lib_ms,
        "shape": f"m={m} k={k} n={n} U={U} (decode wi)"})
    # kernel 1 at every linear shape of the main path: decode m = n_slots,
    # prefill m = one chunk (log lines only)
    for mm in (N_SLOTS, 32):
        for kk, nn in ((1024, 1024), (1024, 2816), (2816, 1024)):
            sets = _em_case(dev, prog, mm, kk, nn, seed=2, copies=4)
            t = time_graph(em.encoded_matmul, sets)
            b = (mm * kk + U * kk * nn * 2 + nn * 4 + mm * nn * 4) / PEAK_BYTES
            log(f"[measure] encoded_matmul m={mm} k={kk} n={nn} U={U}: "
                f"kernel {t:.4f} ms, bound {b * 1e3:.4f} ms (bytes), "
                f"{U * kk * nn * 2 / (t * 1e-3) / 1e12:.3f} TB/s of Wt")
    # kernel 2: decode attention, 4 slots × 16 heads × D 64, f32 pools
    B, Sq, H, D, ps, P = N_SLOTS, 1, 16, 64, PAGE_SIZE, 32
    lens = [100, 200, 300, 400]
    sets, kv_map = _pa_case(dev, B, Sq, H, H, D, ps, P, lens,
                            torch.float32, seed=5, copies=8)
    kw = dict(scale=D ** -0.5, kv_of_q=kv_map)
    err = (pa.paged_attn(*sets[0], **kw) - pa.paged_attn_plain(
        *sets[0], pa._NO_WINDOW, scale=D ** -0.5, G=1)).abs().max().item()
    ms = time_graph(lambda *a: pa.paged_attn(*a, **kw), sets)
    plain_ms = time_loop(lambda *a: pa.paged_attn_plain(
        *a, pa._NO_WINDOW, scale=D ** -0.5, G=1), sets)
    pages_read = sum(l_ // ps + 1 for l_ in lens)         # per kv head
    nbytes = (2 * B * Sq * H * D * 4 + 2 * pages_read * ps * H * D * 4
              + pages_read * 4 + B * 4)
    ops = 4.0 * Sq * D * pages_read * ps * H
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    rows.append({
        "name": "paged_attn", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:131",
        "launches": serve_info["counts"]["paged_attn"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None,
        "shape": f"B={B} Sq={Sq} H={H} D={D} ps={ps} lens={lens} f32"})
    # kernel 2 with quantized pools at the same shape: bytes of the int8
    # or packed-int4 pages read plus their f32 scale rows
    for mode in ("int8", "int4"):
        qsets, kv_map = _pa_quant_case(dev, mode, B, Sq, H, H, D, ps, P,
                                       lens, seed=6, copies=8)
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
        dp = D // 2 if mode == "int4" else D
        nbytes = (2 * B * Sq * H * D * 4 + 2 * pages_read * ps * H * (dp + 4)
                  + pages_read * 4 + B * 4)
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        rows.append({
            "name": f"paged_attn_{mode}", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:131",
            "launches": serve_info[mode]["counts"]["paged_attn"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            # no PyTorch call reads quantized pages through a page table
            "library_ms": None,
            "shape": f"B={B} Sq={Sq} H={H} D={D} ps={ps} lens={lens} {mode} "
                     f"pools, {nbytes / 1e6:.3f} MB"})
    # kernel 3 at the prefill shape of full-width qwen1.5-0.5b: B 4, S 1024,
    # 16 heads, D 64, causal; flattened (B·H, S, D) as flash_mha hands it
    # to the kernel.  Not on the serving path: launches 0 (the reference's
    # model never reaches its flash kernel either).
    from repro_torch.kernels import flash_attention as fa
    Bf, S, Hf, Df = 4, 1024, 16, 64
    for dt, tag, peak in ((torch.float32, "f32", PEAK_F32),
                          (torch.bfloat16, "bf16", PEAK_BF16)):
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
        t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops_f / peak * 1e3
        rows.append({
            "name": f"flash_attention_{tag}", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:24",
            "launches": serve_info["counts"]["flash_attention"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": lib_ms,
            "shape": f"B={Bf} S={S} H={Hf} D={Df} causal {tag} (prefill; "
                     "not on the serving path)"})
    for r in rows:
        log(f"[measure] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"launches on the main path {r['launches']}")
    per_step = serve_info["steps"] + serve_info["chunks"]
    log(f"[measure] launches per engine forward (decode steps + prefill "
        f"chunks = {per_step}): encoded_matmul "
        f"{serve_info['counts']['encoded_matmul'] / per_step:.1f}, "
        f"paged_attn per decode step "
        f"{serve_info['counts']['paged_attn'] / serve_info['steps']:.1f}; "
        f"flash_attention {serve_info['counts']['flash_attention']} (not on "
        "the serving path)")
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
    for key in ("params_enc", "cfg_enc", "trace", "tokens", "stats"):
        del serve_info[key]
    torch.cuda.empty_cache()
    phase_cpu_parity(dev)
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
