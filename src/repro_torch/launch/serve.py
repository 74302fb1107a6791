"""Serving launcher of the port: continuous batching over the paged KV
cache, optionally with calibrated encoded-MAC inference.

  python -m repro_torch.launch.serve --continuous --mac encoded \
      --encoding exact --paged-attn kernel            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --continuous \
      --mac encoded --encoding exact --paged-attn kernel --device cpu

``--paged-attn gather`` / ``kernel`` are the reference CLI's ``xla`` /
``pallas``: the gathered-page-view path, or the fused page-walk op (the
CUDA kernel on the card, its plain PyTorch version on the CPU).  The
weights are random, made from ``--seed``; the request trace comes from
``numpy.random.default_rng(0)`` as in the reference CLI.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) runs the kernels on the card; "
                         "'cpu' runs their plain PyTorch versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mac", default="fp", choices=["fp", "encoded"])
    ap.add_argument("--encoding", default="search",
                    choices=["search", "exact"],
                    help="search = per-family encoding search (not ported "
                         "yet); exact = bit-exact AND-plane circuit")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache "
                         "(the only engine ported so far)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=256)
    ap.add_argument("--reserve", default="conservative",
                    choices=["conservative", "optimistic"])
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--paged-attn", default="gather",
                    choices=["gather", "kernel"])
    ap.add_argument("--calib-batches", type=int, default=4)
    args = ap.parse_args(argv)

    if not args.continuous:
        ap.error("only --continuous serving is ported so far (ROADMAP: "
                 "ServeEngine/generate on the dense cache)")

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_model
    from repro_torch.serve import (Engine, exact_encodings,
                                   prepare_encoded_serving)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attention_backend=args.paged_attn)
    params = init_model(cfg, seed=args.seed, device=dev)
    if args.mac == "encoded":
        if args.encoding != "exact":
            ap.error("--encoding search is not ported yet (ROADMAP: "
                     "encoded-serving bundle cache and family search); use "
                     "--encoding exact")
        t0 = time.time()
        params, cfg, info = prepare_encoded_serving(
            params, cfg, macs_override=exact_encodings(cfg.mac.bits),
            calib_batches=args.calib_batches, device=dev)
        print(f"[encoded-serving] folded {info['n_folded']} linears in "
              f"{time.time() - t0:.1f}s")

    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, rng.integers(4, 24))
            for _ in range(args.requests)]
    if dev.type == "cuda":
        # build the kernels now (first use compiles them with nvcc), so the
        # timed run below measures serving only
        from repro_torch.kernels import build
        build.build()
    engine = Engine(params, cfg, n_slots=args.slots,
                    page_size=args.page_size, n_pages=args.n_pages,
                    reserve=args.reserve, prefill_chunk=args.prefill_chunk,
                    device=dev)
    t0 = time.time()
    rids = [engine.submit(r, max_new=args.max_new) for r in reqs]
    outs = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    st = engine.stats()
    total = st["decode_tokens"]
    print(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, mac={args.mac}, "
          f"paged-attn={args.paged_attn}, device={dev})")
    print(f"  occupancy={st['occupancy']:.2f} evictions={st['evictions']} "
          f"p50={st['latency_p50_s']:.3f}s p99={st['latency_p99_s']:.3f}s "
          f"kv_pool={st['kv_pool_bytes'] / 1e6:.1f}MB")
    for i, rid in enumerate(rids[:3]):
        print(f"req{i}: {list(map(int, outs[rid][:10]))} ...")


if __name__ == "__main__":
    main()
