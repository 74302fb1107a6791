"""Training launcher of the port.

  # on the CPU (reduced config, the plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
  # on the card: full-width qwen1.5-0.5b, encoded-MAC QAT
  PYTHONPATH=src python -m repro_torch.launch.train --steps 200 \
      --batch 8 --seq 256 --mac-mode encoded --ckpt-dir /tmp/ckpt
  # the moe family (router aux loss; deepseek-v3 adds the MTP loss)
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --arch deepseek-v3-671b --steps 4 --batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \
      --arch qwen3-moe-235b-a22b --steps 20 --mac-mode encoded
  # the xlstm family, in every MAC mode
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --arch xlstm-1.3b --steps 4 --batch 2 --seq 32

  # several ranks (gloo): 2 on the CPU, then the reference's mesh on the
  # card with the int8 error-feedback gradient all-reduce
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
      --devices 2 --steps 4 --batch 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --devices 2 \
      --grad-compress --steps 20 --batch 4 --seq 256

The reference's loop (``repro/launch/train.py``): config → (mesh) → train
state (weights from seed 0) → data pipeline (deterministic per step,
prefetch, straggler skip) → train steps with async checkpoints (each
joined before the next starts), an emergency checkpoint on SIGTERM, and a
resume from the newest committed checkpoint under ``--ckpt-dir``.
``--mac-mode encoded`` trains with ``EncodedMac.default()`` (searched on
the card and cached on first use).  An encdec arch (whisper-large-v3)
stops at its first step with the reference's ``AssertionError``: the
synthetic token stream has no encoder frames ``enc_x``
(``make_train_step`` takes batches that carry them).

``--devices N`` (N > 1) spawns N ranks (``parallel.mesh.run_ranks``, on
``--device``) on the reference's mesh: the model axis is the first of 16,
8, 4, 2 that divides both N and ``d_ff``, the data axis the rest; each
rank builds the same global batch from the step and keeps its rows.
Rank 0 prints (the mesh first, as the reference) and writes the
checkpoints, which hold the logical state (``statesharding.
gather_state``), so a run resumes on any number of ranks.  The ranks take
the same steps: the straggler skip is off, and a SIGTERM to any rank
stops them all at the same step.  ``--grad-compress`` adds the error
buffers to the state; the step quantizes under a mesh only, as the
reference's.  Under a mesh the dense archs and qwen3-moe train; the
other families are refused (ROADMAP Queue A, item 1).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import signal
import time


def mesh_shape(n_devices: int, d_ff: int) -> tuple:
    """The reference's ``(data, model)`` for ``n_devices``: the model
    axis is the first of 16, 8, 4, 2 dividing both ``n_devices`` and
    ``d_ff`` (1 if none)."""
    model = next((m for m in (16, 8, 4, 2)
                  if n_devices % m == 0 and d_ff % m == 0), 1)
    return n_devices // model, model


def main(argv=None):
    ap = argparse.ArgumentParser()
    from repro_torch.configs import list_archs
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--mac-mode", default="fp",
                    choices=["fp", "int8", "encoded"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--debug-nan", action="store_true",
                    help="raise on the first non-finite linear output or "
                         "logit (debug-only: one host sync per linear)")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 error-feedback gradient all-reduce over the "
                         "data axis (under --devices)")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to train on (gloo; the reference's fake "
                         "host devices); 0 or 1: one")
    args = ap.parse_args(argv)
    if args.devices > 1:
        from repro_torch.configs import get_config
        from repro_torch.device import resolve_device
        from repro_torch.parallel.mesh import run_ranks
        from repro_torch.parallel.statesharding import check_trainable
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        try:
            check_trainable(cfg)
        except NotImplementedError as e:
            ap.error(f"--devices: {e}")
        resolve_device(args.device)        # no card: fail before spawning
        n_data, n_model = mesh_shape(args.devices, cfg.d_ff)
        run_ranks(_train, n_model, args, n_data=n_data, device=args.device)
        return
    _train(None, args)


def _train(mesh, args):
    """The training loop, alone (``mesh`` None) or as one rank of
    ``mesh``."""
    import torch
    from repro_torch.ckpt import (async_save_checkpoint, latest_step,
                                  restore_checkpoint)
    from repro_torch.configs import get_config
    from repro_torch.core.layers import MacConfig
    from repro_torch.core.mac import EncodedMac
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.device import resolve_device
    from repro_torch.launch.env import set_debug_nan
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.statesharding import gather_state, shard_state
    from repro_torch.train import init_train_state, make_train_step

    lead = mesh is None or mesh.rank == 0
    dev = resolve_device(args.device)
    if args.debug_nan:
        set_debug_nan(True)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.mac_mode != "fp":
        mac = None
        if args.mac_mode == "encoded":
            # one rank at a time: the first searches and caches, the
            # others read the cache
            with contextlib.nullcontext() if mesh is None \
                    else mesh.in_turns():
                mac = EncodedMac.default(device=dev)
        cfg = dataclasses.replace(cfg, mac=MacConfig(mode=args.mac_mode,
                                                     mac=mac))
    if args.microbatch:
        cfg = dataclasses.replace(cfg, microbatch=args.microbatch)
    if mesh is not None and lead:
        print(f"mesh: {dict(mesh.shape)}", flush=True)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, seed=17)
    state = init_train_state(cfg, seed=0, device=dev,
                             grad_compress=args.grad_compress)
    step_fn = make_train_step(cfg, total_steps=args.steps,
                              grad_compress=args.grad_compress)

    start = latest_step(args.ckpt_dir)
    if start is not None:
        if lead:
            print(f"resuming from step {start}", flush=True)
        state = restore_checkpoint(args.ckpt_dir, start, state)
    start = start or 0
    if mesh is not None:
        state = shard_state(state, cfg, mesh)
    pipe = DataPipeline(lambda s: ds.batch(s, args.batch), start_step=start,
                        prefetch=2,
                        skip_threshold=30.0 if mesh is None else None)

    stop = {"now": False}
    signal.signal(signal.SIGTERM, lambda *_: stop.update(now=True))
    ckpt_thread = None
    t0 = time.time()
    try:
        with set_mesh(mesh):
            for i in range(start, args.steps):
                _, b = pipe.next()
                state, m = step_fn(state, b)
                if lead and (i % 10 == 0 or i == args.steps - 1):
                    toks = args.batch * args.seq * (i - start + 1)
                    print(f"step {i} loss {float(m['loss']):.4f} "
                          f"gnorm {float(m['gnorm']):.2f} "
                          f"tok/s {toks / (time.time() - t0):,.0f}",
                          flush=True)
                if mesh is not None:
                    stop["now"] = mesh.any(stop["now"])
                if (i + 1) % args.ckpt_every == 0 or stop["now"]:
                    if ckpt_thread is not None:
                        ckpt_thread.join()
                    whole = state if mesh is None else \
                        gather_state(state, cfg, mesh, device="cpu")
                    if lead:
                        ckpt_thread = async_save_checkpoint(
                            args.ckpt_dir, i + 1, whole)
                    del whole
                    if stop["now"]:
                        if lead:
                            print(f"emergency checkpoint at step {i + 1} "
                                  "committed; exiting", flush=True)
                        break
        if ckpt_thread is not None:
            ckpt_thread.join()
    finally:
        pipe.stop()
    if pipe.skipped:
        print(f"straggler-skipped steps: {pipe.skipped}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if lead:
        print("done", flush=True)


if __name__ == "__main__":
    main()
