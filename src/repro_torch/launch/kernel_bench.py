"""Time the port's kernels 1 and 3 at the main path's shapes on one card.

    python src/repro_torch/launch/kernel_bench.py [--src DIR] [--tag NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is built and
timed (by default this checkout's), so that two checkouts can be compared
in one run on one card: run the script once per checkout, in turns
(``A B B A``).  It uses only entry points both versions have.  Prints one
JSON line per measurement, tagged ``--tag``: kernel ms (a CUDA graph of 40
calls rotating over inputs past the 50 MB L2), max error against the plain
version, and the library call's ms for the same function.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import sys

SHAPES = [(m, k, n) for m in (4, 32)
          for k, n in ((1024, 1024), (1024, 2816), (2816, 1024))]


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
        nbytes = m * k + U * k * n * 2 + n * 4 + m * n * 4
        print(json.dumps({"tag": tag, "kernel": "encoded_matmul", "m": m,
                          "k": k, "n": n, "U": U, "ms": ms,
                          "bound_ms": nbytes / 3.35e12 * 1e3,
                          "rel_err": err, "library_ms": lib_ms,
                          "library": lib_name}), flush=True)


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
        print(json.dumps({"tag": tag, "kernel": "flash_attention",
                          "dtype": str(dt).split(".")[-1], "B": B, "S": S,
                          "H": H, "D": D, "ms": ms, "max_abs_err": err,
                          "library_ms": lib_ms,
                          "library": "scaled_dot_product_attention"}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_bench: needs an NVIDIA card")
    from repro_torch.kernels import build
    build.build()
    bench_em(args.tag)
    bench_flash(args.tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
