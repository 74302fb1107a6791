"""Time the port's kernels at the main path's shapes on one card.

    python src/repro_torch/launch/kernel_bench.py [--src DIR] [--tag NAME]
        [--only em,em_tp,paged,paged_sq,flash]

``--src`` names the ``src`` directory whose ``repro_torch`` is built and
timed (by default this checkout's), so that two checkouts can be compared
in one run on one card: run the script once per checkout, in turns
(``A B B A``).  It uses only entry points both versions have (the launch
floor of kernel 2 where the timed version has ``paged_attn_floor``).
Prints one JSON line per measurement, tagged ``--tag``: kernel ms (a CUDA
graph of 40 calls rotating over inputs past the 50 MB L2), max error
against the plain version, the bound, and the library call's ms for the
same function where there is one; every bound comes from
``launch/roofline.py``.  Kernel 1 at its nine shapes (``em_tp``, not by
default: at a rank's shapes of tensor-parallel serving); kernel 2
(paged attention, 4 slots x 16 heads x D 64, lens 100-400) with dense
f32, int8 and int4 pools at page tables of 32 and 127 pages, and with
``paged_sq`` (not by default) against Sq = 1..16 query tokens per row;
kernel 3 (flash attention) in f32 and bf16 at the prefill shape.
"""
from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import sys

# kernel 1 at decode (m = 4 slots), a prefill chunk (32) and the static
# engine's longest prefill of the main trace (884, where the operations
# bound it)
SHAPES = [(m, k, n) for m in (4, 32, 884)
          for k, n in ((1024, 1024), (1024, 2816), (2816, 1024))]
# kernel 1 at a rank's local (k, n) of tensor-parallel serving at 2 ranks
# (``--only em_tp``): deepseek-v3's MLA wq_b, wk_b/wv_b and wo, dense and
# shared MLPs and head; phi-3-vision's attention, MLP and head; at a data
# row's decode (m = 2), decode (4) and the static prefill (884)
TP_SHAPES = [(m, k, n) for m in (2, 4, 884) for k, n in (
    (1536, 12288), (512, 8192), (8192, 7168), (7168, 9216), (9216, 7168),
    (7168, 1024), (1024, 7168), (7168, 64640),
    (3072, 1536), (1536, 3072), (3072, 4096), (4096, 3072), (3072, 16032))]


@functools.lru_cache(maxsize=None)
def roofline():
    """``launch/roofline.py`` beside this file, loaded by its path: the
    bounds are this checkout's whichever ``--src`` the kernels come from
    (an older checkout may have no such module)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "roofline.py")
    spec = importlib.util.spec_from_file_location("kernel_bench_roofline",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod


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
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def time_eager(fn, arg_sets, iters: int = 4) -> float:
    """ms per call of ``fn`` issued from Python (host overhead included),
    after one warm-up call a set."""
    import torch
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def cuda_kernels_of(fn, attempts: int = 3) -> list:
    """Names of the device kernels (and copies) that one call of ``fn``
    runs, in order (``cuda_kernel_times``)."""
    return [name for name, _ in cuda_kernel_times(fn, attempts)]


def cuda_kernel_times(fn, attempts: int = 3) -> list:
    """``(name, µs)`` of each device kernel (and copy) that one call of
    ``fn`` runs: ``torch.profiler`` over the call, read back from its
    exported trace (written under the checkout's git-ignored ``build/``).
    A capture that recorded no device activity at all is taken again, up
    to ``attempts`` times (on the H100 machine one capture in a few dozen
    came back empty); the last capture is returned either way."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "..", "build", f"trace-{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    names = []
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        names = [(e["name"], float(e.get("dur", 0.0))) for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        if names:
            break
    return names


def bf16_mm():
    """Kernel 1's library yardstick: one bf16 × bf16 product with f32
    output where this torch has ``aten::mm.dtype`` (``out_dtype``), else a
    bf16 product, and which of the two it is."""
    import torch
    a = torch.ones((8, 16), dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(a, a.t(), out_dtype=torch.float32)
    except (TypeError, RuntimeError, NotImplementedError):
        return torch.mm, "torch.mm bf16 -> bf16 (no out_dtype in this torch)"
    return (functools.partial(torch.mm, out_dtype=torch.float32),
            "torch.mm bf16 -> f32 (out_dtype)")


def bench_em(tag):
    import torch
    from repro_torch.core import circuits
    from repro_torch.core.decompose import decompose
    from repro_torch.kernels import encoded_matmul as em
    from repro_torch.kernels.ref import planes_ref
    prog = decompose(circuits.exact_product_circuit(8, 8)[0])
    U, shifts = prog.n_a_planes, prog.a_mono_bits
    lib, lib_name = bf16_mm()
    for m, k, n in SHAPES:
        g = torch.Generator().manual_seed(m + k + n)
        sets = []
        for _ in range(4):
            x = torch.randint(-127, 128, (m, k), generator=g,
                              dtype=torch.int8)
            wt = torch.randint(-127, 128, (U, k, n), generator=g).float()
            wt *= (2.0 ** (torch.arange(U) % 8).float()).reshape(U, 1, 1)
            bias = torch.randn((n,), generator=g) * 100
            sets.append((x.cuda(), wt.to(torch.bfloat16).cuda(),
                         bias.cuda(), shifts))
        out = em.encoded_matmul(*sets[0])
        ref = em.encoded_matmul_plain(*sets[0])
        err = (out - ref).abs().max().item() / ref.abs().max().item()
        ms = time_graph(em.encoded_matmul, sets)
        lib_sets = [(planes_ref(x, sh).to(torch.bfloat16).permute(1, 0, 2)
                     .reshape(m, U * k).contiguous(), wt.reshape(U * k, n))
                    for x, wt, _, sh in sets]
        lib_ms = time_graph(lib, lib_sets)
        bound = roofline().encoded_matmul(m, k, n, U)
        print(json.dumps({"tag": tag, "kernel": "encoded_matmul", "m": m,
                          "k": k, "n": n, "U": U, "ms": ms,
                          "bound_ms": bound.bound_ms,
                          "bound_by": bound.bound_by,
                          "rel_err": err, "library_ms": lib_ms,
                          "library": lib_name}), flush=True)


def bench_paged(tag):
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.quant.kvcache import quantize_kv
    B, H, D, ps = 4, 16, 64, 16
    lens = [100, 200, 300, 400]
    for mode in ("bf16", "int8", "int4"):
        for P in (32, 127):
            rng = np.random.default_rng(5)
            t = lambda *shape: torch.from_numpy(  # noqa: E731
                rng.normal(size=shape).astype(np.float32)).cuda()
            sets = []
            for _ in range(8):
                pk, pv = t(1 + B * P, ps, H, D), t(1 + B * P, ps, H, D)
                sk = sv = None
                if mode != "bf16":
                    pk, sk = quantize_kv(pk, mode)
                    pv, sv = quantize_kv(pv, mode)
                pages = torch.from_numpy(np.stack(
                    [1 + b * P + rng.permutation(P) for b in range(B)])
                    .astype(np.int32)).cuda()
                sets.append((t(B, 1, H, D), pk, pv, pages, torch.tensor(
                    lens, dtype=torch.int32).cuda(), sk, sv))

            def kern(q, pk, pv, pg, ln, sk, sv):
                return pa.paged_attn(q, pk, pv, pg, ln, scale=D ** -0.5,
                                     scale_k=sk, scale_v=sv)

            out = kern(*sets[0])
            ref = pa.paged_attn_plain(*sets[0][:5], 2 ** 30, scale=D ** -0.5,
                                      G=1, scale_k=sets[0][5],
                                      scale_v=sets[0][6])
            err = (out - ref).abs().max().item()
            ms = time_graph(kern, sets)
            floor_ms = None
            if hasattr(pa, "paged_attn_floor"):
                floor_ms = time_graph(
                    lambda: pa.paged_attn_floor(B, H, P, "cuda"), [()] * 8)
            bound = roofline().paged_attn(B, 1, H, H, D, ps, lens, mode)
            print(json.dumps({"tag": tag, "kernel": "paged_attn",
                              "pools": "f32" if mode == "bf16" else mode,
                              "B": B, "H": H, "D": D, "ps": ps, "P": P,
                              "lens": lens, "ms": ms, "floor_ms": floor_ms,
                              "bound_ms": bound.bound_ms,
                              "bound_by": bound.bound_by,
                              "max_abs_err": err, "library_ms": None}),
                  flush=True)


def bench_paged_sq(tag):
    """Kernel 2 against query tokens per row (Sq), dense f32 pools at the
    serve's 127-page table: how its time follows the rows a pass holds
    (``rows_per_pass``, the smallest power of 2 that holds Sq·G, at most
    8 for f32) and the passes over the pages (``passes``)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    B, H, D, ps, P = 4, 16, 64, 16, 127
    lens = [100, 200, 300, 400]
    for sq in (1, 2, 3, 4, 5, 8, 9, 16):
        rng = np.random.default_rng(sq)
        t = lambda *shape: torch.from_numpy(  # noqa: E731
            rng.normal(size=shape).astype(np.float32)).cuda()
        sets = []
        for _ in range(8):
            pages = torch.from_numpy(np.stack(
                [1 + b * P + rng.permutation(P) for b in range(B)])
                .astype(np.int32)).cuda()
            sets.append((t(B, sq, H, D), t(1 + B * P, ps, H, D),
                         t(1 + B * P, ps, H, D), pages,
                         torch.tensor(lens, dtype=torch.int32).cuda()))

        def kern(q, pk, pv, pg, ln):
            return pa.paged_attn(q, pk, pv, pg, ln, scale=D ** -0.5)

        out = kern(*sets[0])
        ref = pa.paged_attn_plain(*sets[0], 2 ** 30, scale=D ** -0.5, G=1)
        err = (out - ref).abs().max().item()
        ms = time_graph(kern, sets)
        rp = min(8, 1 << (sq - 1).bit_length())
        bound = roofline().paged_attn(B, sq, H, H, D, ps, lens)
        print(json.dumps({"tag": tag, "kernel": "paged_attn_sq",
                          "pools": "f32", "B": B, "H": H, "D": D, "ps": ps,
                          "P": P, "lens": lens, "Sq": sq,
                          "rows_per_pass": rp, "passes": -(-sq // rp),
                          "ms": ms, "bound_ms": bound.bound_ms,
                          "bound_by": bound.bound_by,
                          "max_abs_err": err}), flush=True)


def bench_flash(tag):
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    B, S, H, D = 4, 1024, 16, 64
    for dt in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(20)
        sets = [[torch.from_numpy(rng.normal(size=(B * H, S, D)).astype(
            np.float32)).to(dt).cuda() for _ in range(3)] for _ in range(3)]
        kern = functools.partial(fa.flash_attention, scale=D ** -0.5)
        out = kern(*sets[0]).float()
        ref = fa.flash_attention_plain(*sets[0], scale=D ** -0.5).float()
        err = (out - ref).abs().max().item()
        ms = time_graph(kern, sets, iters=20)
        sdpa = functools.partial(
            torch.nn.functional.scaled_dot_product_attention, is_causal=True,
            scale=D ** -0.5)
        lib_ms = time_graph(sdpa, [[t.reshape(B, H, S, D) for t in s]
                                   for s in sets], iters=20)
        # visible pairs x 4·D; f32 on the tensor cores as 3xTF32
        bound = roofline().flash_attention(
            B, S, H, D, 4 if dt == torch.float32 else 2)
        print(json.dumps({"tag": tag, "kernel": "flash_attention",
                          "dtype": str(dt).split(".")[-1], "B": B, "S": S,
                          "H": H, "D": D, "ms": ms, "max_abs_err": err,
                          "bound_ms": bound.bound_ms,
                          "bound_by": bound.bound_by,
                          "route": fa.flash_route(dt, D) if hasattr(
                              fa, "flash_route") else None,
                          "library_ms": lib_ms,
                          "library": "scaled_dot_product_attention"}),
              flush=True)


def bench_em_tp(tag):
    """Kernel 1 at ``TP_SHAPES``: inputs drawn on the card (a head's Wt
    is 7.4 GB), two sets past the L2, the error against the plain
    version on the first and the plain version's ms (``time_eager``)."""
    import torch
    from repro_torch.core import circuits
    from repro_torch.core.decompose import decompose
    from repro_torch.kernels import encoded_matmul as em
    from repro_torch.kernels.ref import planes_ref
    prog = decompose(circuits.exact_product_circuit(8, 8)[0])
    U, shifts = prog.n_a_planes, prog.a_mono_bits
    lib, lib_name = bf16_mm()
    for m, k, n in TP_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(m + k + n)
        mag = 2.0 ** (torch.arange(U, device="cuda") % 8)
        sets = []
        for _ in range(2):
            wt = torch.empty((U, k, n), dtype=torch.bfloat16, device="cuda")
            for u in range(U):                    # a plane at a time
                wt[u] = torch.randint(-127, 128, (k, n), generator=g,
                                      device="cuda", dtype=torch.int16)
                wt[u] *= mag[u]
            x = torch.randint(-127, 128, (m, k), generator=g, device="cuda",
                              dtype=torch.int16).to(torch.int8)
            bias = torch.randn((n,), generator=g, device="cuda") * 100
            sets.append((x, wt, bias, shifts))
        out = em.encoded_matmul(*sets[0])
        ref = em.encoded_matmul_plain(*sets[0])
        err = (out - ref).abs().max().item() / ref.abs().max().item()
        del out, ref
        ms = time_graph(em.encoded_matmul, sets, iters=20)
        lib_sets = [(planes_ref(x, sh).to(torch.bfloat16).permute(1, 0, 2)
                     .reshape(m, U * k).contiguous(), wt.reshape(U * k, n))
                    for x, wt, _, sh in sets]
        lib_ms = time_graph(lib, lib_sets, iters=20)
        del lib_sets
        plain_ms = time_eager(em.encoded_matmul_plain, sets)
        bound = roofline().encoded_matmul(m, k, n, U)
        print(json.dumps({"tag": tag, "kernel": "encoded_matmul", "m": m,
                          "k": k, "n": n, "U": U, "ms": ms,
                          "bound_ms": bound.bound_ms,
                          "bound_by": bound.bound_by,
                          "rel_err": err, "plain_ms": plain_ms,
                          "library_ms": lib_ms,
                          "library": lib_name}), flush=True)
        del sets
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--tag", default="this")
    ap.add_argument("--only", default="em,paged,flash",
                    help="comma-separated: em, em_tp, paged, paged_sq, "
                         "flash")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs an NVIDIA card")
    from repro_torch.kernels import build
    build.build()
    benches = {"em": bench_em, "em_tp": bench_em_tp, "paged": bench_paged,
               "paged_sq": bench_paged_sq, "flash": bench_flash}
    for name in args.only.split(","):
        benches[name](args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
