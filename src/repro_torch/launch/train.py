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

The reference's loop (``repro/launch/train.py``): config → train state
(weights from seed 0) → data pipeline (deterministic per step, prefetch,
straggler skip) → train steps with async checkpoints (each joined before
the next starts), an emergency checkpoint on SIGTERM, and a resume from
the newest committed checkpoint under ``--ckpt-dir``.  ``--mac-mode
encoded`` trains with ``EncodedMac.default()`` (searched on the card and
cached on first use).  An encdec arch (whisper-large-v3) stops at its
first step with the reference's ``AssertionError``: the synthetic token
stream has no encoder frames ``enc_x`` (``make_train_step`` takes batches
that carry them).  The reference's mesh options (``--devices``,
``--grad-compress``) wait for the training half of several ranks (ROADMAP
Queue A item 3) and are refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import signal
import time


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
                    help="not ported: needs several ranks")
    ap.add_argument("--devices", type=int, default=0,
                    help="not ported: the reference's fake host devices")
    args = ap.parse_args(argv)
    if args.devices or args.grad_compress:
        ap.error("--devices and --grad-compress are the reference's mesh "
                 "options; the port trains on one device until the "
                 "training half of several ranks lands (ROADMAP Queue A "
                 "item 3)")

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
    from repro_torch.train import init_train_state, make_train_step

    dev = resolve_device(args.device)
    if args.debug_nan:
        set_debug_nan(True)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.mac_mode != "fp":
        mac = EncodedMac.default(device=dev) \
            if args.mac_mode == "encoded" else None
        cfg = dataclasses.replace(cfg, mac=MacConfig(mode=args.mac_mode,
                                                     mac=mac))
    if args.microbatch:
        cfg = dataclasses.replace(cfg, microbatch=args.microbatch)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, seed=17)
    state = init_train_state(cfg, seed=0, device=dev)
    step_fn = make_train_step(cfg, total_steps=args.steps)

    start = latest_step(args.ckpt_dir)
    if start is not None:
        print(f"resuming from step {start}", flush=True)
        state = restore_checkpoint(args.ckpt_dir, start, state)
    start = start or 0
    pipe = DataPipeline(lambda s: ds.batch(s, args.batch), start_step=start,
                        prefetch=2, skip_threshold=30.0)

    stop = {"now": False}
    signal.signal(signal.SIGTERM, lambda *_: stop.update(now=True))
    ckpt_thread = None
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            _, b = pipe.next()
            state, m = step_fn(state, b)
            if i % 10 == 0 or i == args.steps - 1:
                toks = args.batch * args.seq * (i - start + 1)
                print(f"step {i} loss {float(m['loss']):.4f} "
                      f"gnorm {float(m['gnorm']):.2f} "
                      f"tok/s {toks / (time.time() - t0):,.0f}", flush=True)
            if (i + 1) % args.ckpt_every == 0 or stop["now"]:
                if ckpt_thread is not None:
                    ckpt_thread.join()
                ckpt_thread = async_save_checkpoint(args.ckpt_dir, i + 1,
                                                    state)
                if stop["now"]:
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
    print("done", flush=True)


if __name__ == "__main__":
    main()
