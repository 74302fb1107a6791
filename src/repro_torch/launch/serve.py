"""Serving launcher of the port: a static batch over the dense KV cache
(the default) or continuous batching over the paged KV cache
(``--continuous``), optionally with calibrated encoded-MAC inference.

  # static batch (dense KV cache), on the CPU and on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --requests 6 --max-new 8
  python -m repro_torch.launch.serve --arch qwen1.5-4b --mac encoded \
      --encoding exact
  # on the card: per-family encoding search (the default --encoding
  # search), fold, bundle cache under src/repro_torch/core/artifacts/
  python -m repro_torch.launch.serve --continuous --mac encoded \
      --paged-attn kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --continuous \
      --mac encoded --paged-attn kernel --device cpu \
      --calib-samples 16 --calib-refine 8
  # the bit-exact AND-plane circuit instead of a search
  python -m repro_torch.launch.serve --continuous --mac encoded \
      --encoding exact --paged-attn kernel
  # int8 / int4 paged KV pools, dequantized inside the kernel's page loop
  python -m repro_torch.launch.serve --continuous --mac encoded \
      --encoding exact --paged-attn kernel --kv-dtype int8
  # prefix cache, and speculative decoding with a lower-M encoded drafter
  python -m repro_torch.launch.serve --continuous --mac encoded \
      --paged-attn kernel --prefix-cache --spec-decode 4 --draft encoded
  # the moe family: qwen3-moe on both engines (continuous: paged pools,
  # kernel 2), deepseek-v3 (MLA, static only); on the card full width
  # with the depth cut (--layers) and, for deepseek-v3, bf16 weights
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --arch qwen3-moe-235b-a22b --continuous --paged-attn kernel
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --arch deepseek-v3-671b --mac encoded --encoding exact
  python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \
      --layers 2 --continuous --paged-attn kernel --mac encoded \
      --encoding exact
  python -m repro_torch.launch.serve --arch deepseek-v3-671b --layers 2 \
      --param-dtype bfloat16 --mac encoded --encoding exact
  # the prefix cache and speculative decoding on qwen3-moe; the int8
  # fake-quant executor on both engines; the vlm and hybrid archs (static)
  python -m repro_torch.launch.serve --arch qwen3-moe-235b-a22b \
      --layers 2 --continuous --paged-attn kernel --prefix-cache \
      --spec-decode 4
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --mac int8 --continuous
  python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --layers 4 \
      --mac encoded --encoding exact
  python -m repro_torch.launch.serve --arch hymba-1.5b --layers 4 \
      --mac encoded --encoding exact
  # the xlstm and encdec families (static); whisper serves fp or int8
  # (its calibration needs encoder inputs: --mac encoded raises, as in
  # the reference), and the CLI, as the reference's, feeds it no enc_x
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --arch xlstm-1.3b --mac encoded --encoding exact
  python -m repro_torch.launch.serve --arch xlstm-1.3b --layers 8 \
      --mac encoded --encoding exact
  python -m repro_torch.launch.serve --arch whisper-large-v3 --layers 4 \
      --mac int8
  # telemetry (continuous engine only): lifecycle trace (Perfetto), the
  # metrics registry, device-time attribution, online drift, profiler
  # trace and the allocator sanitizer
  python -m repro_torch.launch.serve --continuous --mac encoded \
      --encoding exact --paged-attn kernel --trace-out t.json \
      --metrics-out m.json --time-device --drift-every 8 \
      --profile-dir prof --sanitize
  # serving over a mesh: the CLI spawns D·M ranks (gloo; on the card
  # they share it), rank 0 prints; every arch but hymba and xlstm (MLA,
  # the vlm and whisper static only).  --mesh M is tensor parallel;
  # --mesh DxM adds a data axis (one scheduler on every rank, the decode
  # slots and static chunks split over data rows)
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --continuous --mac encoded --encoding exact --mesh 2
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --continuous --mesh 2x2
  python -m repro_torch.launch.serve --continuous --mac encoded \
      --encoding exact --paged-attn kernel --mesh 2
  python -m repro_torch.launch.serve --arch deepseek-v3-671b --layers 2 \
      --param-dtype bfloat16 --mac encoded --encoding exact --mesh 2

``--paged-attn gather`` / ``kernel`` are the reference CLI's ``xla`` /
``pallas``: the gathered-page-view path, or the fused page-walk op (the
CUDA kernel on the card, its plain PyTorch version on the CPU).  On the
card every continuous engine step, and the static engine's decode step,
runs as a captured CUDA graph.  ``--arch`` takes every arch of the
reference (``configs/registry.py``): the four dense-family archs, the
two moe-family ones, phi-3-vision-4.2b (vlm), hymba-1.5b (hybrid),
xlstm-1.3b (xlstm) and whisper-large-v3 (encdec); MLA (deepseek-v3), a
vlm, a hybrid, an xlstm and an encdec arch cannot page and serve static
only (the CLI, as the reference's, feeds a vlm no image and an encdec
arch no ``enc_x``).  ``--mac int8`` serves the int8 fake-quant executor
(plain PyTorch on every device: no kernel).  ``--layers`` cuts the depth
(full width; an encdec arch keeps N encoder and N decoder layers, an
xlstm arch takes only a multiple of its ``slstm_every``),
``--param-dtype`` sets the weights' dtype.  The
weights are random, made from ``--seed``; the request trace comes from
``numpy.random.default_rng(0)`` as in the reference CLI.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import re
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    from repro_torch.configs import list_archs
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0, metavar="N",
                    help="keep N layers at full width (a moe arch keeps "
                         "at least one MoE layer, an encdec arch N encoder "
                         "and N decoder layers; an xlstm arch takes a "
                         "multiple of slstm_every); 0 = the arch's depth")
    ap.add_argument("--param-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="the weights' dtype (default: the config's); "
                         "compute stays in the config's dtype")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) runs the kernels on the card; "
                         "'cpu' runs their plain PyTorch versions")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mac", default="fp", choices=["fp", "int8", "encoded"])
    ap.add_argument("--encoding", default="search",
                    choices=["search", "exact"],
                    help="search = task-specific per-family search (paper); "
                         "exact = bit-exact AND-plane circuit (debug)")
    ap.add_argument("--m-bits", type=int, default=48,
                    help="encoding output width M per family")
    ap.add_argument("--calib-samples", type=int, default=128,
                    help="random-search samples per family")
    ap.add_argument("--calib-refine", type=int, default=64,
                    help="anneal refinement iters per family")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over the paged KV cache "
                         "(default: static batches over the dense cache)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--n-pages", type=int, default=256)
    ap.add_argument("--reserve", default="conservative",
                    choices=["conservative", "optimistic"])
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prefix caching: reuse pool pages holding full "
                         "prompt pages already prefilled by earlier "
                         "requests; only the uncached suffix is prefilled")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    # observability: continuous engine only
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the request-lifecycle trace here: Chrome "
                         "trace-event JSON (open in Perfetto / "
                         "chrome://tracing), or JSONL when PATH ends in "
                         ".jsonl; tracing is off without this flag")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the full metrics-registry snapshot "
                         "(counters/gauges/histograms) as JSON")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="wrap the serving run in a torch.profiler trace "
                         "(Chrome trace with every kernel's device time, "
                         "written to DIR/torch_trace.json)")
    ap.add_argument("--time-device", action="store_true",
                    help="device-time attribution: wait for the card after "
                         "every prefill/decode step so device step time "
                         "separates from host scheduler time (adds a sync "
                         "per step)")
    ap.add_argument("--drift-every", type=int, default=0, metavar="N",
                    help="with --mac encoded: sample dense-vs-encoded "
                         "top-1 logit agreement online every N engine "
                         "steps and publish it as a gauge (0 = off)")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens per slot "
                         "per round with the drafter, verify all K+1 "
                         "positions in one batched forward, commit the "
                         "longest agreeing prefix + bonus token (greedy "
                         "output token-identical to K=0); 0 = off")
    ap.add_argument("--draft", default="self", choices=["self", "encoded"],
                    help="drafter for --spec-decode: 'self' = the "
                         "verifier's own params (the gain is fewer "
                         "dispatches alone), 'encoded' = a lower-m-bits "
                         "encoded bundle built by prepare_drafter")
    ap.add_argument("--draft-m-bits", type=int, default=24,
                    help="encoding width M for --draft encoded (coarser "
                         "than the verifier's --m-bits: cheaper drafts, "
                         "lower acceptance)")
    ap.add_argument("--paged-attn", default="gather",
                    choices=["gather", "kernel"])
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["bf16", "int8", "int4"],
                    help="paged KV-cache storage: 'bf16' = dense pages in "
                         "the compute dtype; 'int8'/'int4' store pages "
                         "quantized with per-token per-head scale rows and "
                         "dequantize inside the paged-attention page loop")
    ap.add_argument("--calib-batches", type=int, default=4)
    ap.add_argument("--force-calib", action="store_true",
                    help="rebuild the artifact bundle even if cached")
    ap.add_argument("--debug-nan", action="store_true",
                    help="raise on the first NaN any linear or the logits "
                         "produce (debug-only: runs every step eagerly and "
                         "syncs per linear)")
    ap.add_argument("--sanitize", action="store_true",
                    help="attach the allocator shadow ledger (validates "
                         "every page transition + per-step conservation; "
                         "REPRO_SANITIZE=1 does the same)")
    ap.add_argument("--mesh", default=None,
                    help="serving over D·M ranks ('M': tensor parallel, "
                         "or 'DxM': D data rows of M): the CLI spawns them "
                         "(gloo), rank 0 prints; every arch but hymba "
                         "and xlstm")
    args = ap.parse_args(argv)

    if args.kv_dtype != "bf16" and not args.continuous:
        ap.error("--kv-dtype quantizes the PAGED cache; it requires "
                 "--continuous")
    if args.spec_decode and not args.continuous:
        ap.error("--spec-decode requires --continuous (the draft/verify "
                 "rounds run against the paged KV cache)")
    if args.spec_decode < 0:
        ap.error("--spec-decode must be >= 0")
    try:
        cfg = _config(args)
    except ValueError as e:
        ap.error(f"--layers: {e}")
    if args.mesh:
        from repro_torch.parallel.mesh import run_ranks
        m = re.fullmatch(r"(?:(\d+)x)?(\d+)", args.mesh)
        if m is None:
            ap.error(f"--mesh {args.mesh!r}: expected 'M' or 'DxM' "
                     "(e.g. --mesh 8 or --mesh 2x4)")
        n_data, n_model = int(m.group(1) or 1), int(m.group(2))
        if n_data < 1 or n_model < 1:
            ap.error("--mesh needs at least one rank on each axis")
        from repro_torch.parallel.sharding import SERVED_FAMILIES
        if cfg.family not in SERVED_FAMILIES:
            ap.error(f"--mesh: {args.arch} is not ported to tensor "
                     "parallelism, only the dense, moe, vlm and encdec "
                     "archs (ROADMAP Queue A, item 1: hymba and xlstm)")
        if args.drift_every:
            ap.error("--drift-every runs the whole model on one rank; it is "
                     "not ported under --mesh")
        from repro_torch.device import resolve_device
        resolve_device(args.device)        # no card: fail before spawning
        run_ranks(_serve, n_model, args, n_data=n_data, device=args.device)
        return
    _serve(None, args)


def _config(args):
    from repro_torch.configs import get_config
    from repro_torch.core.layers import MacConfig
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = cfg.with_layers(args.layers)
    if args.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.param_dtype)
    if args.mac == "int8":
        cfg = dataclasses.replace(cfg, mac=MacConfig(mode="int8"))
    return dataclasses.replace(cfg, attention_backend=args.paged_attn,
                               kv_cache_dtype=args.kv_dtype)


def _serve(mesh, args):
    """The serve, alone (``mesh`` None) or as one rank of ``mesh``: the
    ranks make their params, bundles and engines in turns (a bundle one
    writes is a cache hit for the next, and a rank's whole params are
    freed once its engine holds its slices); rank 0 prints and writes."""
    import numpy as np
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.obs import DriftMonitor
    from repro_torch.serve import Engine, ServeEngine
    from repro_torch.serve.telemetry import ServeTelemetry

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    if args.debug_nan:
        from repro_torch.launch.env import set_debug_nan
        set_debug_nan(True)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # build the kernels now (first use compiles them with nvcc), so the
        # timed run below measures serving only
        from repro_torch.kernels import build
        build.build()
    tel = drift = None
    with contextlib.nullcontext() if mesh is None else mesh.in_turns():
        params, cfg, draft_params, draft_cfg, params_ref, cfg_ref = \
            _prepare(args, dev, say, lead)
        if not args.continuous:
            engine = ServeEngine(params, cfg, batch_slots=args.slots,
                                 max_len=128, device=dev, mesh=mesh)
        else:
            if args.drift_every > 0:
                drift = DriftMonitor(params_ref, cfg_ref,
                                     every=args.drift_every)
            tel = ServeTelemetry(trace=bool(args.trace_out) and lead,
                                 time_device=args.time_device, drift=drift,
                                 profile_dir=args.profile_dir if lead
                                 else None)
            engine = Engine(params, cfg, n_slots=args.slots,
                            page_size=args.page_size, n_pages=args.n_pages,
                            reserve=args.reserve,
                            prefill_chunk=args.prefill_chunk,
                            prefix_cache=args.prefix_cache, telemetry=tel,
                            spec_decode=args.spec_decode,
                            draft_params=draft_params, draft_cfg=draft_cfg,
                            sanitize=args.sanitize or None, device=dev,
                            mesh=mesh)
        del params, draft_params, params_ref

    rng = np.random.default_rng(0)
    reqs = [rng.integers(0, cfg.vocab_size, rng.integers(4, 24))
            for _ in range(args.requests)]
    if not args.continuous:
        t0 = time.time()
        outs = engine.run(reqs, max_new=args.max_new)
        dt = time.time() - t0
        total = sum(args.max_new for _ in reqs)
        say(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
            f"({total / dt:.1f} tok/s, mac={args.mac}, static)")
        _say_mesh(say, mesh, engine.stats(), engine.params)
        for i, o in enumerate(outs[:3]):
            say(f"req{i}: {list(map(int, o[:10]))} ...")
        return
    t0 = time.time()
    rids = [engine.submit(r, max_new=args.max_new) for r in reqs]
    outs = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    st = engine.stats()
    total = st["decode_tokens"]
    say(f"served {len(reqs)} requests, {total} tokens in {dt:.2f}s "
        f"({total / dt:.1f} tok/s, mac={args.mac}, "
        f"paged-attn={args.paged_attn}, device={dev})")
    say(f"  occupancy={st['occupancy']:.2f} evictions={st['evictions']} "
        f"jit_compiles={st['jit_compiles']} "
        f"p50={st['latency_p50_s']:.3f}s p99={st['latency_p99_s']:.3f}s "
        f"kv_pool={st['kv_pool_bytes'] / 1e6:.1f}MB")
    say(f"  kv: dtype={st['kv_cache_dtype']} "
        f"{st['kv_bytes_per_token']:.1f} B/token, "
        f"capacity={st['kv_capacity_tokens']} tokens")
    if args.prefix_cache:
        say(f"  prefix: hit_rate={st['prefix_hit_rate']:.2f} "
            f"({st['prefix_hit_tokens']}/{st['prefix_lookup_tokens']} "
            f"tokens, {st['prefix_pages_indexed']} pages indexed, "
            f"{st['cow_copies']} copy-on-write, {st['prefill_chunks']} "
            f"prefill chunks of {st['prefill_chunk']})")
    if args.spec_decode:
        say(f"  spec: k={st['spec_decode_k']} "
            f"acceptance={st['spec_acceptance_rate']:.3f} "
            f"tokens/round={st['spec_tokens_per_round']:.2f} "
            f"({st['spec_accepted_tokens']}/{st['spec_draft_tokens']} "
            f"drafts accepted over {st['spec_rounds']} rounds, "
            f"drafter={st['draft_mac_mode']})")
    say(f"  ttft_p50={st['ttft_p50_s']:.3f}s "
        f"tpot_p50={st['tpot_p50_s']:.4f}s "
        f"step_p50={st['step_ms_p50']:.2f}ms")
    if args.time_device:
        say(f"  device: decode_p50={st['device_decode_ms_p50']:.2f}ms "
            f"prefill_p50={st['device_prefill_ms_p50']:.2f}ms")
    if drift is not None and drift.last is not None:
        # under spec decoding drift comes from verification, which does
        # not observe |Δlogit|
        delta = (float("nan") if drift.last_delta is None
                 else drift.last_delta)
        say(f"  drift: top1_agreement={drift.last:.4f} "
            f"abs_logit_delta={delta:.4f}")
    _say_mesh(say, mesh, st, engine.params)
    if lead:
        jsonl = args.trace_out and args.trace_out.endswith(".jsonl")
        tel.write(trace_out=None if jsonl else args.trace_out,
                  trace_jsonl=args.trace_out if jsonl else None,
                  metrics_out=args.metrics_out)
    for p in (args.trace_out, args.metrics_out):
        if p:
            say(f"  wrote {p}")
    for i, rid in enumerate(rids[:3]):
        say(f"req{i}: {list(map(int, outs[rid][:10]))} ...")


def _prepare(args, dev, say, lead):
    """The params from ``--seed`` and, with ``--mac encoded`` or an
    encoded drafter, their bundles: (params, cfg, draft_params,
    draft_cfg, params_ref, cfg_ref), the last two the fp model (the
    drift monitor's reference)."""
    from repro_torch.models import init_model
    from repro_torch.serve import (arch_families, exact_encodings,
                                   prepare_drafter, prepare_encoded_serving)
    cfg = _config(args)
    params = init_model(cfg, seed=args.seed, device=dev)
    params_ref, cfg_ref = params, cfg
    if args.mac == "encoded":
        overrides = (exact_encodings(cfg.mac.bits, arch_families(cfg))
                     if args.encoding == "exact" else None)
        t0 = time.time()
        params, cfg, info = prepare_encoded_serving(
            params, cfg, m_bits=args.m_bits, n_samples=args.calib_samples,
            refine=args.calib_refine, calib_batches=args.calib_batches,
            macs_override=overrides, force=args.force_calib, device=dev,
            verbose=lead)
        say(f"[encoded-serving] ready in {time.time() - t0:.1f}s "
            f"({'cache hit' if info['loaded'] else 'searched+folded'})")
    draft_params = draft_cfg = None
    if args.spec_decode and args.draft == "encoded":
        verifier = (params, cfg) if args.mac == "encoded" else None
        t0 = time.time()
        draft_params, draft_cfg, dinfo = prepare_drafter(
            params_ref, cfg_ref, m_bits=args.draft_m_bits,
            verifier=verifier, n_samples=args.calib_samples,
            refine=args.calib_refine, calib_batches=args.calib_batches,
            force=args.force_calib, device=dev, verbose=lead)
        src = ("verifier artifacts" if dinfo.get("shared_with_verifier")
               else "searched+folded" if not dinfo.get("loaded")
               else "cache hit")
        say(f"[spec-decode] encoded drafter m_bits={args.draft_m_bits} "
            f"ready in {time.time() - t0:.1f}s ({src})")
    return params, cfg, draft_params, draft_cfg, params_ref, cfg_ref


def _say_mesh(say, mesh, st, params):
    if mesh is not None:
        t = params["embed"]["table"]
        ops = {f"{ax}/{op}": n for (ax, op), n in sorted(mesh.by_axis.items())}
        say(f"  mesh: {st['mesh']} replicated={st['mesh_replicated']} "
            f"data_split={st['data_split']} "
            f"collectives={mesh.collectives} {ops} "
            f"({mesh.collective_s * 1e3:.1f} ms on the host); the "
            f"embedding: {t.numel() * t.element_size() / 1e6:.1f} MB a rank")


if __name__ == "__main__":
    main()
