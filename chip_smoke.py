#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises and exits non-zero before the result line):

 1. card check: CUDA present; the card's name and power limit
    (``nvidia-smi``);
 2. build: every kernel of the path from ``src/repro_torch/csrc``, one
    ``nvcc`` per source, all started together;
 3. kernel 1 (encoded bitplane matmul) against its plain PyTorch version
    on the card, at the main path's shapes, a sampled M = 48 program with
    3-bit monomials and ragged shapes;
 4. kernel 2 (paged attention) against its plain version: ragged lens
    including 0 and page boundaries, f32 and bf16 pools, GQA, window +
    softcap, Sq = 3;
 5. the main path: qwen1.5-0.5b at full width and depth (weights from seed
    0), calibrated encoded-MAC serving with the exact AND-plane encoding
    and the fused paged-attention kernel, continuous batching of 8
    requests over 4 slots; the kernels' launch counts are set to 0 just
    before the run and read just after.  Then one decode step with every
    slot busy is timed on the host clock and, as a measurement only, its
    forward replayed from a CUDA graph (the card's time without the
    host's);
 6. the reduced config and the same trace served on the card (kernels)
    and on the CPU (plain versions): identical greedy tokens;
 7. per-kernel times at the main path's decode shape beside their bound,
    the plain version's time and a library call's, as one JSON line.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
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


def _serve(params, cfg, trace, device, max_new: int = MAX_NEW):
    from repro_torch.serve import Engine
    eng = Engine(params, cfg, n_slots=N_SLOTS, page_size=PAGE_SIZE,
                 n_pages=N_PAGES, device=device)
    rids = [eng.submit(p, max_new=max_new) for p in trace]
    return eng, rids


def _reset_counts():
    from repro_torch.kernels import encoded_matmul as em
    from repro_torch.kernels import paged_attention as pa
    em.encoded_matmul.launches = 0
    pa.paged_attn.launches = 0


def _read_counts():
    from repro_torch.kernels import encoded_matmul as em
    from repro_torch.kernels import paged_attention as pa
    return {"encoded_matmul": em.encoded_matmul.launches,
            "paged_attn": pa.paged_attn.launches}


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
        f"paged_attn {counts['paged_attn']}")
    assert len(outs) == N_REQUESTS and all(
        len(outs[r]) == MAX_NEW for r in rids), "not every request finished"
    assert all(0 <= t < cfg.vocab_size for r in rids for t in outs[r])
    for name, n in counts.items():
        assert n > 0, f"kernel {name} was not launched on the main path"
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
    return {"counts": counts, "steps": st["decode_steps"],
            "chunks": st["prefill_chunks"], "tok_s": n_tok / dt}


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
    outs = {}
    for name, params, device in (("cpu", pe_cpu, "cpu"),
                                 ("cuda", pe_gpu, dev)):
        eng, rids = _serve(params, ce, trace, device)
        _reset_counts()
        res = eng.run()
        counts = _read_counts()
        outs[name] = [res[r].tolist() for r in rids]
        log(f"[parity] reduced on {name}: {sum(map(len, outs[name]))} "
            f"tokens, launches {counts}")
        if name == "cuda":
            for k, n in counts.items():
                assert n > 0, f"{k} not launched on the card"
        else:
            assert all(n == 0 for n in counts.values())
    same = outs["cpu"] == outs["cuda"]
    log(f"[parity] greedy tokens card (kernels) vs CPU (plain): "
        f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("card and CPU greedy tokens differ")
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
        f"{serve_info['counts']['paged_attn'] / serve_info['steps']:.1f}")
    return rows


def main() -> int:
    t_start = time.perf_counter()
    dev = card_check()
    import torch
    phase_build()
    phase_kernel1(dev)
    phase_kernel2(dev)
    serve_info = phase_serve(dev)
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
