#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises and exits non-zero before the result line):

 1. card check: CUDA present; the card's name and power limit
    (``nvidia-smi``);
 2. build: every kernel from ``src/repro_torch/csrc``, one ``nvcc`` per
    source, all started together;
 3. kernel 1 (encoded bitplane matmul) against its plain PyTorch version
    on the card (the inputs of phases 3-5 drawn on the card from a seed),
    at the main path's shapes, a sampled M = 48 program with
    3-bit monomials and ragged shapes (m past one 32-row pass, k and n
    off the tiles); and its rows at m = 4 bit for bit the same rows at
    m = 20 (speculative verification's m), and at the static engine's
    prefills of the main trace (m = 884 and 360); then at every (k, n)
    of qwen1.5-4b, starcoder2-3b and gemma2-27b at m = 4, 32, 884 and
    360 (gemma2 also at its long request's static 4200 and 1), Wt made
    on the card (qwen1.5-4b's untied head: 3.1e9 elements, past 2^31).
    Every full-width serve below fails if it launches kernel 1 at an
    (m, k, n) not held here;
 4. kernel 2 (paged attention) against its plain version: ragged lens
    including 0 and page boundaries, f32 and bf16 pools, GQA, window +
    softcap, Sq = 3, 5 and 9 (speculative verification at k = 4 and 8),
    and the serve's 127-page table with an idle row and a row filling
    the table; then the same with int8 and packed-int4 pools
    (and the quantizer's codes and scales on the card against the CPU's,
    bit for bit), at the main path's decode shape too; one call is one
    CUDA kernel (``torch.profiler`` kernel events) for each pool type;
    and at head dim 128 (the dense archs') with f32, bf16, int8 and int4
    pools, 20/20, 24/2 and 32/16 heads, Sq 1 and 5, window 100 with
    softcap 50;
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
    alone (the card's busy share); the decode graph's kernel-1/2/3 nodes,
    read from the graph itself, must equal what a replay adds to the
    launch counts (so must the draft and verify graphs' in 6d);
 6c. the prefix cache: a trace where 4 of 8 requests share a 128-token
    prefix, served with the cache on and off (identical tokens, hits > 0),
    and ``copy_page`` on full-width dense, int8 and int4 card pools,
    scale rows included, in place and bit for bit;
 6d. speculative decoding over the main trace: k = 4 and 8 with the
    ``self`` drafter and k = 4 with an ``encoded`` drafter searched on the
    card at M = 24 (bundle in a fresh ``build/`` directory, removed
    after): tokens identical to plain decode, acceptance and tokens per
    round, launch counts by shape;
 6g. telemetry and the allocator sanitizer on the main path (the exact
    encoding, dense f32 pools, graphed): the trace on engines with
    telemetry off, tracing on, and tracing with ``time_device`` (tokens
    identical, repeat-serve tok/s and step p50/p99 printed); traced,
    timed and sanitized: tokens identical to phase 6, each request's
    phase spans summing to its span within 1 us, one ``device:decode``
    span per decode step, registry counters and histogram counts equal to
    ``stats()`` and the launch counts' forwards, ``jit_compiles`` by step
    equal to the graphs' captures, the ledger clean, the written Chrome
    trace and metrics JSON parsed; the drift monitor every 8 steps
    against the fp params (agreement in [0, 1], tokens identical, its
    encoded forwards counted in kernel 1's launches at m = 19, 25 and 32,
    gated in phase 3); spec decoding k = 4 with the monitor fed by
    verification (gauge = accepted / considered, kernel 1's launches
    those of phase 6d's k = 4 serve); the shared-prefix trace sanitized
    with a page shared by a peer (a copy-on-write through the ledger,
    tokens those of 6c); one serve under ``torch.profiler`` whose dump
    names kernels 1 and 2;
 6e. the static engine (``ServeEngine`` over the dense KV cache) on the
    main trace in chunks of 4 (each chunk builds its cache and graph
    anew), graphed (three serves) and eager: identical tokens, kernel 1
    at every linear of every forward and kernel 2 never; against the
    continuous engine's tokens, each split logged with its position and
    logit margin and its origin: both engines run again eagerly while a
    hook reads the split request's int8 activation codes, and the first
    position and linear where they differ is logged with the values
    before rounding; a split must start at a code that f32 order moved
    across a .5 boundary (``ORIGIN_TOL``), or be a near-tie; the same two
    engines with the fp weights: identical tokens or near-ties under
    ``FP_TIE_RTOL``;
 6f. qwen1.5-4b (2 layers), starcoder2-3b (2) and gemma2-27b (2: one
    local, one global) at full width, weights drawn on the card from seed
    0, calibrated
    and folded on the card with the exact encoding (no bundle write),
    serving the main trace through the continuous engine (kernel 2) and
    ``ServeEngine``, each graphed and eager (identical tokens), with
    launches by (m, k, n) and by Sq, static against continuous as in 6e
    (encoded gated on each split's origin, fp as near-ties); gemma2 also serves one 4,200-token
    request past layer 0's 4096 window, whose live layer-0 pools hold
    kernel 2 against its plain version with the window (which must move
    the output); folded bytes and peak memory per arch;
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
    inputs and int8 activation codes part between card and CPU); then
    each other dense arch's reduced config through both engines, card
    against CPU: identical greedy tokens;
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
    the verify shape m = 20 and kernel 2 at Sq = 5 and 9 (phase 6d);
    kernel 1 at the static engine's prefill shapes (m = 884 and 360,
    launches from the 6e serve); kernel 2 at the other dense archs' head
    layouts (D = 128, f32 pools, 127-page table), launches from their
    phase 6f serves (kernel 1 at the other archs' shapes is gated in
    phases 3 and not timed, to keep the script within its limit).
    Kernel-1 rows of the static path's shapes also carry
    ``launches_static``, the static serve's count.

 9. the trainer (run before 8): full-width qwen1.5-0.5b (weights from
    seed 0, synthetic LM data, AdamW, remat on) trained at batch 8 x 256
    tokens in each MAC mode (``fp`` 10 steps, the others 4), ``int8``
    (fake quant) and
    ``encoded`` (QAT with the exact encoding, and 4 steps with
    ``EncodedMac.default()``, searched on the card at first use, whose
    loss is recorded, not gated): every loss and gnorm finite, the last
    loss below the first, kernels 1-3 launched 0 times; step ms p50, tokens/s and peak
    device memory per mode, and with remat off (fp); the QAT fold's share
    of an encoded step's device time (``torch.profiler``);
    ``microbatch=2`` against the full batch (rtol 5e-4 / atol 5e-5); an
    encoded run of 3 steps against 2 steps, an async checkpoint, a restore
    into a fresh state and the third step, bit for bit under deterministic
    algorithms (an op without a deterministic CUDA path is named and the
    check falls back to that tolerance); the reduced config trained 5
    steps from one torch-made state on the card and on the CPU (fp losses
    within 1e-4; int8/encoded step 0's loss and first moments within
    1e-4, or a parting at step 0 that starts at an int8 code f32 order
    moved across a .5 boundary; later steps printed, and where they part
    the first int8 code apart and the params furthest apart).  int8 and
    the exact encoding train 4 steps (``TRAIN_QUANT_STEPS``; the exact
    run's step 0 equals int8's).  Phase 7 runs ``python -m
    repro_torch.launch.train --steps 2 --batch 4 --seq 128 --mac-mode
    encoded --ckpt-every 2`` at full width (its resume: phase 7's reduced
    ``--devices 2`` run).
 10. the paper's side (run after 9, before 8; ``apps/image_cls.py``,
    ``apps/paper.py``): (a) the reduced Table 2 pipeline (600 images, 1
    epoch, 5 fine-tune steps; weights drawn with numpy from seed 0) on
    the card and on the CPU: fp training losses within ``CARD_CPU_RTOL``
    and params within 2e-3; from the CPU's trained net on both, fp
    logits within 1e-4 of max|logit|, and int8 and the exact encoding
    (calibrated, position weights fine-tuned) with identical predictions,
    or each split's first int8 code apart within ``ORIGIN_TOL`` of .5
    (or, with no code apart, a near-tie); (b) Table 2 in full on the card
    (``EncodedMac.default()``, cached by phase 9) plus the exact encoding
    on the same trained net: fp accuracy at least 0.9, int8 within 0.01
    of fp, exact within 0.002 of int8 (the default encoding's rows are
    printed, not gated); (c) Table 1 within 0.05 of the paper, the
    latency simulator equal to both closed forms; (d) Fig 7 whole, Fig 5
    and Fig 6 at width 48 only, printed; kernels 1-3 launched 0 times
    (the encoded conv net folds in f32 outside kernel 1, as the
    reference's); one ``{"paper": {...}}`` line with each part's seconds.

The moe family (``MOE_ARCHS``): phase 3 also gates kernel 1 at every
(k, n) of qwen3-moe-235b-a22b and deepseek-v3-671b at full width, at each
m their serves run (the two heads' Wt past 2^32 elements), and phase 4
kernel 2 at qwen3-moe's 64/4 heads for every pool type.  Phase 6h serves
both at full width with the depth cut (qwen3-moe 2 of 94 layers, f32;
deepseek-v3 one dense and one MoE layer, bf16 weights, f32 compute),
weights drawn on the card: qwen3-moe continuous (dense f32, int8, int4
pools) and static, deepseek-v3 static, exact encoding and fp, graphed
and eager (identical tokens), a repeat serve on the same engine
(identical); launches as the forwards make them, flash never; the
static-vs-continuous agreement and each engine's MoE drops (recomputed
from the routing of the eager serves) are logged, not gated (capacity
follows each call's padded B·S).  Phase 7 holds both reduced configs
card vs CPU: tokens on both engines, and 5 fp train steps (router aux,
MTP loss).  Each phase logs its seconds (``[phase]``).

The prefix cache and speculative decoding on qwen3-moe: phase 3 gates
kernel 1 at its verify m = 20 too, and phase 4 kernel 2 at its verify
shapes (64/4 heads, D 128, Sq 5 and 9: 80 and 144 rows a kv head, which
f32 pools take in two chunks of shared memory) for every pool type over
a 127-page table.  Phase 6h serves the shared-prefix trace of 6c with
the cache on and off and the main trace with spec decoding (k = 4, the
``self`` drafter), exact encoding, f32 pools, graphed and eager
(identical), the draft and verify graphs' kernel nodes counted; cache on
vs off and spec vs plain are logged with each eager run's MoE drops and
gated as identical only where both drop 0 pairs (each call's capacity
follows its own padded B·S).  Phase 7 holds qwen3-moe reduced with the
prefix cache and with spec decoding card vs CPU.

The vlm and hybrid families (``NEW_ARCHS``): phase 3 also gates kernel 1
at every (k, n) of phi-3-vision-4.2b and hymba-1.5b at decode m = 4 and
their static prefills (hymba's with its 128 meta tokens, m = 4·(S +
128); its ``wbcdt``, n = 132, is the first unaligned n of a serve).
Phase 6i serves both at full width, 4 of 32 layers (hymba: layer 0
global, layers 1-3 windowed at 2048), weights drawn on the card, through
``ServeEngine`` (neither pages) with the exact encoding and fp weights,
graphed and eager (identical), a repeat serve identical; launches by
(m, k, n), kernels 2 and 3 never; folded bytes, peak memory, step p50
and tok/s.  Phase 7 holds both reduced configs card vs CPU
(``ServeEngine``; phi-3-vision through ``generate`` with an ``img`` from
the seed; 5 fp train steps), and serves reduced qwen1.5-0.5b through the
serve CLI with ``--mac int8`` on both engines.  Phase 8 adds kernel 2's
rows at Sq 5 and 9 with a group of 16.

The xlstm and encdec families (``XLSTM_ARCH``, ``WHISPER_ARCH``):
phase 3 also gates kernel 1 at every (k, n) of xlstm-1.3b at decode m = 4
and the static prefills (the sLSTM FFN's ``wup``, n = 5460, takes the
unaligned-n fill; its ``wo``, k = 2730, a ragged last k-tile).  Phase 6j
serves xlstm-1.3b at full width, 8 of 48 blocks (7 mLSTM, 1 sLSTM),
weights drawn on the card, through ``ServeEngine`` with the exact
encoding and fp weights, graphed and eager (identical), a repeat serve
identical, kernel 1 at every linear of every forward and kernels 2 and 3
never, and the sLSTM block's share of a prefill; and whisper-large-v3 at
full width, 4 + 4 of 32 + 32 layers, fp and ``--mac int8``, through
``generate`` with 1500 frames of ``enc_x`` from the seed (graphed =
eager, a repeat identical) and once through ``ServeEngine`` without
``enc_x`` as the CLI serves it; kernels 1-3 never (whisper serves no
encoded MAC, as in the reference).  Phase 7 holds reduced xlstm (one
mLSTM and one sLSTM block, exact encoding, ``ServeEngine``) and reduced
whisper (``generate`` with ``enc_x``) card vs CPU, and 5 fp train steps
of each.

Tensor-parallel serving (``TP`` = 2 ranks over gloo, sharing the one
card): phase 3 also gates kernel 1 at every local (k, n) a TP serve
launches (column n/2, row k/2; qwen1.5-0.5b and qwen3-moe) at each m
those serves run, and phase 4 kernel 2 at the local heads (8/8 at D 64
for every pool type, Sq 1 and 5; qwen3-moe's 32/2 at D 128), with
head-sharded calls against the whole call's heads logged bit for bit.
Phase 6k spawns the ranks (``parallel.mesh.run_ranks``): each loads
phase 6's exact bundle (a cache hit under the mesh) and keeps its slices
(folded bytes exactly half), then serves qwen1.5-0.5b at full width and
depth through the continuous engine with f32, int8 and int4 pools, the
prefix cache on 6c's trace and spec decoding k = 4 (``self``), each on
every request of its trace to ``MAX_NEW`` new tokens, and
``ServeEngine`` in chunks of 4, all eager (gloo's collectives cannot be
captured); then qwen3-moe at 6h's depth, weights drawn and folded on
the card in turns (one rank's whole params at a time), expert-parallel
on both engines.  Gates: every rank's tokens, stats and allocator state
equal; tokens equal to the same phase's single-rank eager serve (6, 6c,
6d, 6e, 6h); kernel launches by local shape, gated; MoE drops equal to
6h's.  Logged beside the card: eager tok/s at TP 2 against single-rank
eager, collectives a decode step and their host ms, per-rank folded
bytes and peak memory.  Phase 7 also runs the serve CLI on the card with
``--mesh 2`` (reduced, exact encoding, kernel 2), whose 2 ranks must
print the tokens of the same command without it and load its bundle (a
cache hit), and ``--mesh 2x2``, which must exit 2.  Phase 8 adds kernel
1's rows at the TP-2 local shapes and kernel 2's at 8/8 heads.

Training on several ranks (``MESH_TRAIN_RUNS``), in phase 6k's spawn
after its serves: full-width qwen1.5-0.5b, 4 of 24 layers, AdamW, 4 x
256 tokens a step from seed 0's state: TP 2 (the 1 x 2 mesh) 3 fp steps
and 2 exact-encoded QAT steps, DP 2 (a 2 x 1 mesh over the same ranks)
3 fp steps and 3 with ``grad_compress``.  While the ranks start this
process runs the same steps on one rank (the compressed ones through a
1 x 1 mesh of its own, where the step quantizes as the reference's
single-device chain); the ranks wait for it before they serve.
Gates: losses within 1e-3, params within rtol = atol = 2e-3 and first
moments within 1e-4 of each leaf's max of one rank after the last step
(the steps move a param by less than 2e-3; an encoded run may part only
where the first int8 code apart, ``_linear_inputs`` read before each
step, sits within ``ORIGIN_TOL`` of .5), every rank's gathered state
equal; the compressed run's first step's int8 codes the single rank's
but where both values sit within ``ORIGIN_TOL`` of .5, its scales
within 1e-5, its error buffers non-zero and equal on the ranks; the TP-2
state after its fp steps, written by rank 0 as one logical checkpoint,
restored on one rank here: its next step within the same tolerances of
the one-rank state's.  Logged: step ms p50 a
mesh, collectives, their host ms and bytes all-reduced a step, peak
memory a rank.  Phase 7 runs the train CLI reduced with ``--devices
2`` (2 ranks spawned by it, the reference's mesh choice printed, losses
within 1e-3 of the same command on one rank), then resumes that run on
one rank from the 2 ranks' step-2 checkpoint.

Every phase that folds writes its bundle into a fresh directory under
``build/`` (git-ignored), logs the free disk first and removes it at its
end (phase 6's stays until phase 6k has loaded it).  The last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
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
# the other dense-family archs at full width, depth cut (phase 6f; 2
# layers each, where 4 held qwen1.5-4b and starcoder2-3b until the TP
# phase took the time): gemma2 keeps one local (window 4096) and one
# global layer
ARCH_DEPTHS = (("qwen1.5-4b", 2), ("starcoder2-3b", 2), ("gemma2-27b", 2))
# gemma2's long request (phase 6f): past layer 0's 4096-token window
LONG_PROMPT = 4200
# the moe family at full width, depth cut (phase 6h): (arch, layers, the
# weights' dtype).  qwen3-moe keeps 2 of 94 layers in f32 (19.3 GB of
# experts); deepseek-v3 its first dense layer and one MoE layer in bf16 (in
# f32 its 256 experts alone would take 45 GB a layer), as the reference's
# ``for_mesh`` sets for models past 4e9 parameters; compute stays f32
MOE_ARCHS = (("qwen3-moe-235b-a22b", 2, "float32"),
             ("deepseek-v3-671b", 2, "bfloat16"))
# the vlm and hybrid families at full width, depth cut (phase 6i): hymba
# keeps layer 0 global and windows layers 1-3 at 2048
NEW_ARCHS = (("phi-3-vision-4.2b", 4), ("hymba-1.5b", 4))
# the xlstm and encdec families at full width, depth cut (phase 6j):
# xlstm-1.3b keeps 8 of 48 blocks, one group of 7 mLSTM and 1 sLSTM
# (a multiple of its slstm_every, where the reference's two layer orders
# agree); whisper-large-v3 4 of its 32 encoder and 4 of its 32 decoder
# layers, its encoder fed Whisper's 30-s window after the conv stem
XLSTM_ARCH, XLSTM_DEPTH = "xlstm-1.3b", 8
WHISPER_ARCH, WHISPER_DEPTH, WHISPER_FRAMES = "whisper-large-v3", 4, 1500
# with fp weights two engines may part only at a near-tie: the candidates'
# logits within this share of the largest |logit| (f32 summation orders
# part them by about 1e-6 of it at full width)
FP_TIE_RTOL = 1e-4
# with the exact encoding a static/continuous split must start at an int8
# activation code that f32 summation order moved across a .5 rounding
# boundary: that code's value within this of the boundary on both sides
# and every earlier encoded input within this of the other engine's (x /
# scale units; f32 orders part them by about 4e-5 at full width)
ORIGIN_TOL = 1e-3
# kernel 1's (m, k, n) held against its plain version with the exact
# encoding's U (phases 3); every full-width serve's launches must fall in it
GATED_EM = set()
# phase 6k: tensor-parallel ranks, all on the one card
TP = 2
# phase 6k's serves (qwen1.5-0.5b) and the m each runs kernel 1 at:
# decode and draft steps, prefill chunks, verify at k = SPEC_K, the static
# prefills
TP_MS = (N_SLOTS, 32, N_SLOTS * (SPEC_K + 1))
# phase 6g's drift monitor: a sample every 8 engine steps, of at most 2
# resident prompts cut to 32 tokens (the monitor's defaults)
DRIFT_EVERY, DRIFT_MAX_LEN = 8, 32
# the card's name and power limit (nvidia-smi), logged beside measurements
SMI = ""


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


def static_prefill_ms(meta: int = 0):
    """Kernel 1's m in the static engine's prefills of the main trace: one
    per chunk of ``N_SLOTS`` requests, batch x (its longest prompt + the
    arch's ``meta`` tokens) (largest first; the trace's lengths do not
    depend on the vocab)."""
    lens = [len(p) for p in make_trace(2)]
    return sorted({len(lens[c:c + N_SLOTS]) * (max(lens[c:c + N_SLOTS])
                                               + meta)
                   for c in range(0, N_REQUESTS, N_SLOTS)}, reverse=True)


def drift_ms():
    """Kernel 1's m in the drift monitor's encoded forwards over the main
    trace: each sampled prompt's length, cut to the monitor's 32 tokens."""
    return sorted({min(len(p), DRIFT_MAX_LEN) for p in make_trace(2)})


def _check_gated(counts, where):
    """Every (m, k, n) at which a full-width serve launched kernel 1 was
    held against the plain version in phases 3."""
    missed = sorted(set(counts["encoded_matmul_by_shape"]) - GATED_EM)
    assert not missed, f"kernel 1 ran at (m, k, n) {missed} {where}, never " \
        "held against its plain version"


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
    global SMI
    SMI = smi
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
    """Kernel 1's inputs, drawn on the card: x (m, k) int8 codes and
    ``copies`` sets of Wt (U, k, n) bf16 (exact-fold magnitudes: 2^i ·
    code, |value| ≤ 128·127) and bias."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    U = prog.n_a_planes
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev,
                      dtype=torch.int16).to(torch.int8)
    mag = (2.0 ** (torch.arange(U, device=dev) % 8)).reshape(U, 1, 1)
    sets = []
    for _ in range(copies):
        wt = torch.randint(-127, 128, (U, k, n), generator=g, device=dev,
                           dtype=torch.int16).float() * mag
        bias = torch.randn((n,), generator=g, device=dev) * 100
        sets.append((x, wt.to(torch.bfloat16), bias, prog.a_mono_bits))
    return sets


def _em_dev_case(dev, prog, ms, k, n, seed=0):
    """``_em_case``'s distribution made on the card (real-size Wt of up to
    6 GB, past what the host should draw): x for each m in ``ms``, one
    Wt and bias."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    U = prog.n_a_planes
    # a plane at a time: a 7.4e9-element Wt would need as much again in
    # int16 at once
    wt = torch.empty((U, k, n), dtype=torch.bfloat16, device=dev)
    for u in range(U):
        wt[u] = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                              dtype=torch.int16).to(torch.bfloat16)
        wt[u] *= 2.0 ** (u % 8)                   # exact: powers of 2
    bias = torch.randn((n,), generator=g, device=dev) * 100
    xs = [torch.randint(-127, 128, (m, k), generator=g, device=dev,
                        dtype=torch.int8) for m in ms]
    return xs, wt, bias, prog.a_mono_bits


def _arch_cfg(arch: str, n_layers=None):
    import dataclasses as dc
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dc.replace(cfg, n_layers=n_layers or cfg.n_layers,
                      attention_backend="kernel")


def _arch_em_shapes(cfg, tp=1):
    """(k, n) of an arch's encoded linears, each once (``tp``: a rank's
    local shapes)."""
    return sorted(_linear_shapes(cfg, tp=tp),
                  key=lambda kn: (kn[0] * kn[1], kn))


def phase_kernel1_archs(dev):
    """Kernel 1 at every (k, n) of the other dense archs, at each m their
    serves run: continuous decode (m = 4) and prefill chunks (32), static
    prefills of the trace's chunks (``static_prefill_ms``) and, for
    gemma2, the long request's static prefill and decode (m = 4200 and
    1); real-size Wt made on the card (qwen1.5-4b's untied head:
    8·2560·151936 elements, past 2^31)."""
    import torch
    from repro_torch.kernels import encoded_matmul as em
    prog = _program("exact")
    n_cases = 0
    for arch, _ in ARCH_DEPTHS:
        ms = (N_SLOTS, 32) + tuple(static_prefill_ms()) + (
            (1, LONG_PROMPT) if arch == "gemma2-27b" else ())
        for k, n in _arch_em_shapes(_arch_cfg(arch)):
            xs, wt, bias, sh = _em_dev_case(dev, prog, ms, k, n,
                                            seed=k + n)
            for x in xs:
                out = em.encoded_matmul(x, wt, bias, sh)
                ref = em.encoded_matmul_plain(x, wt, bias, sh)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                top = ref.abs().max().item()
                ok = torch.allclose(out, ref, rtol=1e-4, atol=1e-4 * top) \
                    and bool(torch.isfinite(out).all())
                log(f"[kernel1] {arch:13s} U={prog.n_a_planes} "
                    f"m={x.shape[0]:4d}"
                    f" k={k:5d} n={n:6d} (Wt {wt.numel() / 2 ** 31:.2f}x 2^31 "
                    f"elements) max_abs_err={err:.3e} (atol {1e-4 * top:.3e})"
                    f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel1 disagrees with plain at "
                                         f"{arch} {(x.shape[0], k, n)}")
                GATED_EM.add((x.shape[0], k, n))
                n_cases += 1
                del out, ref
            del xs, wt, bias
            torch.cuda.empty_cache()
    log(f"[kernel1] {n_cases} cases of the dense archs within tolerance")


def _moe_cfg(arch, reduced=False):
    """A moe arch of ``MOE_ARCHS`` at its cut depth and weight dtype (or
    reduced), serving paged attention through kernel 2."""
    from repro_torch.configs import get_config
    _, depth, pdtype = next(a for a in MOE_ARCHS if a[0] == arch)
    cfg = get_config(arch)
    cfg = cfg.reduced() if reduced else dataclasses.replace(
        cfg.with_layers(depth), param_dtype=pdtype)
    return dataclasses.replace(cfg, attention_backend="kernel")


def _moe_ms(arch):
    """Kernel 1's m in the serves of phase 6h: static prefills of the
    trace's chunks and decode at batch ``N_SLOTS`` (both engines, and the
    draft steps), and where the arch pages the continuous engine's
    32-token prefill chunks (with the prefix cache too) and speculative
    verification at k = ``SPEC_K`` (m = N_SLOTS·(k+1))."""
    from repro_torch.models import supports_paged_cache
    pages = supports_paged_cache(_moe_cfg(arch))
    return (N_SLOTS,) + ((32, N_SLOTS * (SPEC_K + 1)) if pages else ()) \
        + tuple(static_prefill_ms())


def phase_kernel1_moe(dev):
    """Kernel 1 at every (k, n) of the moe archs at full width, at each m
    their serves run (``_moe_ms``), exact U, real-size Wt made on the
    card, against its plain version at error 0 (exact-fold magnitudes:
    every partial sum is an integer both sum exactly): qwen3-moe's head 8 x 4096 x 151936 = 4.98e9 elements and
    deepseek-v3's 8 x 7168 x 129280 = 7.41e9, past 2^32; deepseek-v3's
    ``wkr`` (n = 64, one column tile) and ``wk_b``/``wv_b`` (k = 512)."""
    import torch
    from repro_torch.kernels import encoded_matmul as em
    prog = _program("exact")
    n_cases, worst = 0, 0.0
    for arch, _, _ in MOE_ARCHS:
        cfg = _moe_cfg(arch)
        ms = _moe_ms(arch)
        shapes = sorted(set(_linear_shapes(cfg)) | set(
            _linear_shapes(cfg, decode=True)), key=lambda kn: kn[0] * kn[1])
        for k, n in shapes:
            xs, wt, bias, sh = _em_dev_case(dev, prog, ms, k, n, seed=k + n)
            for x in xs:
                out = em.encoded_matmul(x, wt, bias, sh)
                ref = em.encoded_matmul_plain(x, wt, bias, sh)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                ok = err == 0.0 and bool(torch.isfinite(out).all())
                log(f"[kernel1-moe] {arch:19s} U={prog.n_a_planes} "
                    f"m={x.shape[0]:4d} k={k:5d} n={n:6d} (Wt "
                    f"{wt.numel() / 2 ** 32:.2f}x 2^32 elements) "
                    f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel1 disagrees with plain at "
                                         f"{arch} {(x.shape[0], k, n)}")
                GATED_EM.add((x.shape[0], k, n))
                n_cases += 1
                worst = max(worst, err)
                del out, ref
            del xs, wt, bias
            torch.cuda.empty_cache()
    log(f"[kernel1-moe] {n_cases} cases of the moe archs, every one at "
        f"error {worst:.3e} against plain")


def _new_cfg(arch, reduced=False):
    """A vlm or hybrid arch of ``NEW_ARCHS`` at its cut depth (or
    reduced)."""
    from repro_torch.configs import get_config
    depth = next(d for a, d in NEW_ARCHS if a == arch)
    cfg = get_config(arch)
    return cfg.reduced() if reduced else cfg.with_layers(depth)


def _gate_em_archs(dev, tag, cases):
    """Kernel 1 against its plain version at every (k, n) of each (arch,
    cfg, ms[, tp]) of ``cases`` (``tp``: a rank's local shapes), at each
    m of ``ms``; real-size Wt made on the card.  Each gated (m, k, n)
    joins ``GATED_EM``."""
    import torch
    from repro_torch.kernels import encoded_matmul as em
    prog = _program("exact")
    n_cases = 0
    for arch, cfg, ms, *tp in cases:
        for k, n in _arch_em_shapes(cfg, *tp):
            xs, wt, bias, sh = _em_dev_case(dev, prog, ms, k, n,
                                            seed=k + n)
            for x in xs:
                out = em.encoded_matmul(x, wt, bias, sh)
                ref = em.encoded_matmul_plain(x, wt, bias, sh)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                top = ref.abs().max().item()
                ok = torch.allclose(out, ref, rtol=1e-4, atol=1e-4 * top) \
                    and bool(torch.isfinite(out).all())
                log(f"[{tag}] {arch:17s} U={prog.n_a_planes} "
                    f"m={x.shape[0]:4d} k={k:5d} n={n:6d} "
                    f"max_abs_err={err:.3e} (atol {1e-4 * top:.3e}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel1 disagrees with plain at "
                                         f"{arch} {(x.shape[0], k, n)}")
                GATED_EM.add((x.shape[0], k, n))
                n_cases += 1
                del out, ref
            del xs, wt, bias
            torch.cuda.empty_cache()
    log(f"[{tag}] {n_cases} cases within tolerance")


def phase_kernel1_new(dev):
    """Kernel 1 at every (k, n) of phi-3-vision-4.2b and hymba-1.5b at
    full width, at each m their static serves run: decode (m = 4) and the
    static prefills of the trace's chunks, hymba's with its 128 meta
    tokens (``static_prefill_ms(meta)``); hymba's ``wbcdt`` (k 3200, n
    132) is the first serving shape whose n is not a multiple of 8 (the
    element-by-element fill and a ragged last n-tile)."""
    cases = []
    for arch, _ in NEW_ARCHS:
        cfg = _new_cfg(arch)
        cases.append((arch, cfg, (N_SLOTS,)
                      + tuple(static_prefill_ms(cfg.meta_tokens))))
    _gate_em_archs(dev, "kernel1-new", cases)


def _xlstm_cfg(reduced=False):
    """xlstm-1.3b at its cut depth, or reduced with one mLSTM and one
    sLSTM block (``reduced()`` alone keeps no sLSTM block)."""
    from repro_torch.configs import get_config
    cfg = get_config(XLSTM_ARCH)
    if reduced:
        return dataclasses.replace(cfg.reduced(), slstm_every=2)
    return cfg.with_layers(XLSTM_DEPTH)


def _whisper_cfg(reduced=False):
    from repro_torch.configs import get_config
    cfg = get_config(WHISPER_ARCH)
    return cfg.reduced() if reduced else cfg.with_layers(WHISPER_DEPTH)


def phase_kernel1_xlstm(dev):
    """Kernel 1 at every (k, n) of xlstm-1.3b at full width (the mLSTM's
    wi 2048x8192 and wo 4096x2048, the sLSTM's wi 2048x8192, wup
    2048x5460 and wo 2730x2048, the head 2048x50304), at the m its static
    serve runs: decode (m = 4) and the static prefills of the trace's
    chunks.  ``wup``'s n = 5460 takes the unaligned-n fill, ``wo``'s k =
    2730 a zero-filled ragged k-tile."""
    _gate_em_archs(dev, "kernel1-xlstm", [
        (XLSTM_ARCH, _xlstm_cfg(), (N_SLOTS,) + tuple(static_prefill_ms()))])


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
    # the static engine's prefills over the main trace (m = 884, 360)
    cases += [("exact", exact, m, k, n) for m in static_prefill_ms()
              for k, n in ((1024, 1024), (1024, 2816), (2816, 1024))]
    # the drift monitor's encoded forwards (phase 6g: m = 19, 25; 32 is
    # the prefill chunk's)
    cases += [("exact", exact, m, k, n) for m in drift_ms() if m != 32
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
        if tag == "exact":
            GATED_EM.add((m, k, n))
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
    """Kernel 2's inputs: ``copies`` sets of (q, pool_k, pool_v, pages,
    lens) and the head map; q and the pools normal, drawn on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + B * P
    g = max(1, Hq // Hkv)
    kv_map = np.minimum(np.arange(Hq) // g, Hkv - 1).astype(np.int32)
    pages = np.zeros((B, P), np.int32)
    for b in range(B):
        pages[b] = 1 + b * P + rng.permutation(P)

    def t(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    sets = []
    for _ in range(copies):
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


def phase_kernel2_d128(dev):
    """Kernel 2 at head dim 128 (an f32 row of 512 bytes, the kernel's
    largest) with the dense archs' head layouts (20/20 qwen1.5-4b, 24/2
    starcoder2-3b, 32/16 gemma2-27b), Sq 1 and 5, f32, bf16, int8 and int4
    pools, gemma2's layout with window 100 and softcap 50, and qwen3-moe's
    64/4 (GQA group 16) at Sq 1, and at Sq 5 and 9 (its verify forwards:
    80 and 144 rows a kv head; f32 pools take them in two chunks) over a
    127-page table, one row filling it."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    ps, D = 16, 128
    lens = [0, 16, 17, 511]
    cases = [(Hq, Hkv, sq, None, None) for Hq, Hkv in
             ((20, 20), (24, 2), (32, 16)) for sq in (1, 5)]
    cases += [(32, 16, sq, 100, 50.0) for sq in (1, 5)]
    # qwen3-moe's decode: 64 query heads over 4 kv heads (group 16), Sq 1;
    # and its verify forwards at k = 4 and 8 (80 and 144 rows a kv head)
    # over the serve's 127-page table, lens up to the table's end
    cases += [(64, 4, 1, None, None)]
    cases += [(64, 4, sq, None, None, SERVE_P) for sq in (SPEC_K + 1, 9)]
    for mode in ("f32", "bf16", "int8", "int4"):
        for Hq, Hkv, Sq, window, cap, *pp in cases:
            P = pp[0] if pp else 32
            ln = [min(x, P * ps - Sq) for x in
                  (lens if not pp else [0, 100, 1000, P * ps])]
            seed = Hq + Hkv + Sq
            if mode in ("f32", "bf16"):
                dt = torch.float32 if mode == "f32" else torch.bfloat16
                (args,), kv_map = _pa_case(dev, 4, Sq, Hq, Hkv, D, ps, P, ln,
                                           dt, seed=seed)
                sk = sv = None
            else:
                ((args, (sk, sv)),), kv_map = _pa_quant_case(
                    dev, mode, 4, Sq, Hq, Hkv, D, ps, P, ln, seed=seed)
            kw = dict(scale=D ** -0.5, cap=cap, scale_k=sk, scale_v=sv)
            out = pa.paged_attn(*args, window=window, kv_of_q=kv_map, **kw)
            ref = pa.paged_attn_plain(*args, window or pa._NO_WINDOW,
                                      G=Hq // Hkv, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = (dict(rtol=0.0, atol=2e-2) if mode == "bf16"
                   else dict(rtol=1e-4, atol=1e-5))
            ok = torch.allclose(out.float(), ref.float(), **tol) and \
                bool(torch.isfinite(out.float()).all())
            log(f"[kernel2-d128] {mode:4s} B=4 Sq={Sq} Hq={Hq} Hkv={Hkv} "
                f"D={D} window={window} cap={cap} P={P} lens={ln} "
                f"max_abs_err={err:.3e} {tol} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel2 disagrees with plain at D=128 "
                                     f"{mode} {(Hq, Hkv, Sq, window)}")


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
    """Kernel 3's q, k, v (B, S, heads, D), normal, drawn on the card."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((B, S, h, D), generator=gen, device=dev)
                 .to(dtype) for h in (Hq, Hkv, Hkv))


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


def phase_kernel1_tp(dev):
    """Kernel 1 at every local (k, n) of phase 6k's serves at ``TP`` ranks
    (column n/TP, row k/TP): qwen1.5-0.5b's wq/wk/wv 1024x512, wi/wg
    1024x1408, attention wo 512x1024 and MLP wo 1408x1024 (its tied head
    is an fp product) at decode, prefill chunk, verify (``TP_MS``) and the
    static prefills; qwen3-moe's wq 4096x4096, wk/wv 4096x256, wo
    4096x4096 and head 4096x75968 at decode, prefill chunk and the static
    prefills."""
    from repro_torch.configs import get_config
    qwen = dataclasses.replace(get_config("qwen1.5-0.5b"),
                               attention_backend="kernel")
    pre = tuple(static_prefill_ms())
    _gate_em_archs(dev, "kernel1-tp", [
        ("qwen1.5-0.5b", qwen, TP_MS + pre, TP),
        ("qwen3-moe-235b-a22b", _moe_cfg("qwen3-moe-235b-a22b"),
         (N_SLOTS, 32) + pre, TP)])


def phase_kernel2_tp(dev):
    """Kernel 2 at the heads a rank of ``TP`` holds, over the serve's
    127-page table: qwen1.5-0.5b's 8/8 at D 64 with f32, int8 and int4
    pools at Sq 1 and 5 (decode, verify at k = 4), qwen3-moe's 32/2 at D
    128 with f32 pools at Sq 1; each rank's slice of a whole call's heads
    and pools against the plain version, and against the whole call's
    output for those heads (bit for bit or not, logged: the cluster size
    follows the heads, so a rank's call may sum its pages in another
    order)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    cases = [(8, 8, 64, sq, mode) for mode in ("f32", "int8", "int4")
             for sq in (1, SPEC_K + 1)] + [(32, 2, 128, 1, "f32")]
    ps, P = PAGE_SIZE, SERVE_P
    for Hq, Hkv, D, Sq, mode in cases:
        ln = [0, 100, 1000, P * ps - Sq]
        seed = Hq + Hkv + Sq
        if mode == "f32":
            (args,), kv_map = _pa_case(dev, N_SLOTS, Sq, Hq * TP, Hkv * TP,
                                       D, ps, P, ln, torch.float32,
                                       seed=seed)
            sc = (None, None)
        else:
            ((args, sc),), kv_map = _pa_quant_case(
                dev, mode, N_SLOTS, Sq, Hq * TP, Hkv * TP, D, ps, P, ln,
                seed=seed)
        q, pk, pv, pages, lens = args
        kw = dict(scale=D ** -0.5)
        whole = pa.paged_attn(q, pk, pv, pages, lens, kv_of_q=kv_map,
                              scale_k=sc[0], scale_v=sc[1], **kw)
        local_map = (np.arange(Hq) // (Hq // Hkv)).astype(np.int32)
        for r in range(TP):
            qs, ks = slice(r * Hq, (r + 1) * Hq), slice(r * Hkv,
                                                        (r + 1) * Hkv)
            a = (q[:, :, qs].contiguous(), pk[:, :, ks].contiguous(),
                 pv[:, :, ks].contiguous(), pages, lens)
            s_ = tuple(None if t is None else t[..., ks].contiguous()
                       for t in sc)
            out = pa.paged_attn(*a, kv_of_q=local_map, scale_k=s_[0],
                                scale_v=s_[1], **kw)
            ref = pa.paged_attn_plain(*a, pa._NO_WINDOW, G=Hq // Hkv,
                                      scale_k=s_[0], scale_v=s_[1], **kw)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = torch.allclose(out, ref, rtol=1e-4, atol=1e-5) and \
                bool(torch.isfinite(out).all())
            same = torch.equal(out, whole[:, :, qs])
            log(f"[kernel2-tp] {mode} rank {r} of {TP}: B={N_SLOTS} Sq={Sq} "
                f"Hq={Hq} Hkv={Hkv} D={D} P={P} lens={ln} max_abs_err="
                f"{err:.3e} {'ok' if ok else 'FAIL'}; against the whole "
                f"{Hq * TP}/{Hkv * TP}-head call's heads: "
                f"{'bit-identical' if same else 'apart by %.3e' % (out - whole[:, :, qs]).abs().max().item()}"
                f" (cluster {pa.cluster_size(N_SLOTS, Hkv, P, _n_sm(dev))} "
                f"vs {pa.cluster_size(N_SLOTS, Hkv * TP, P, _n_sm(dev))})")
            if not ok:
                raise AssertionError(f"kernel2 disagrees with plain at the "
                                     f"TP heads {(mode, Hq, Hkv, D, Sq)}")


def _n_sm(dev) -> int:
    import torch
    return torch.cuda.get_device_properties(dev).multi_processor_count


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


def _check_counts(counts, st, cfg, chunk_len, where, gated=False,
                  extra=None, tp=1):
    """Every kernel of the path launched, paged attention once per layer
    per forward that attends through it (prefill chunks take the gather
    path), by query tokens per row; encoded matmul at every linear of
    every forward, by (m, k, n), each of them gated in phases 3 where
    ``gated``; flash never.  ``extra``: cacheless encoded forwards beside
    the serve's (the drift monitor's), {m: forwards}."""
    by_m, attn = _forwards(st, chunk_len)
    if extra:
        by_m = by_m + collections.Counter(extra)
    for name in PATH_KERNELS:
        assert counts[name] > 0, f"{name} was not launched {where}"
    want = {sq: cfg.n_layers * n for sq, n in attn.items()}
    assert counts["paged_attn_by_sq"] == want, \
        f"paged_attn launched {counts['paged_attn_by_sq']} times by Sq " \
        f"{where}, not {cfg.n_layers} per layer x {dict(attn)}"
    assert counts["paged_attn"] == sum(want.values())
    shapes = _path_shapes(cfg, by_m, tp=tp)
    assert counts["encoded_matmul_by_shape"] == shapes, \
        f"encoded_matmul shapes {counts['encoded_matmul_by_shape']} " \
        f"!= {shapes} {where}"
    assert counts["flash_attention"] == 0, f"flash launched {where}"
    if gated:
        _check_gated(counts, where)


def _tp_splits(cfg, tp: int) -> tuple:
    """The model axis's split of (attention heads, MLP hidden, shared
    expert, vocab) at ``tp`` ranks: ``tp`` where it divides the dim
    (attention: both head counts), else 1 (``parallel.sharding``)."""
    def div(n):
        return tp if n and n % tp == 0 else 1
    ta = tp if div(cfg.n_kv_p) == tp and div(cfg.n_heads_p) == tp else 1
    return (ta, div(cfg.d_ff),
            div(cfg.n_shared_experts * cfg.d_ff_expert), div(cfg.vocab_p))


def _linear_shapes(cfg, decode: bool = False, tp: int = 1) -> dict:
    """Encoded linears of one forward by (k, n): per layer the attention's
    (wq, wk, wv, wo; with MLA wq_a, wq_b, wkv_a, wkr, wo, and in a prefill
    wk_b, wv_b, which decode reads raw), a hybrid layer's SSM (win, wbcdt,
    wout; its wdt is a plain product) and the MLP's (wi, wg for gated
    MLPs, wo: the dense MLP, or a MoE layer's shared expert; the router
    and routed experts are plain products), an xLSTM layer's (the mLSTM's
    wi and wo, the sLSTM's wi, wup and wo; its conv, q/k/v blocks, gates
    and recurrence are plain products), and an untied LM head (a tied
    head reads the embedding table, an fp product).  ``decode``: a
    one-token step over a cache.  ``tp``: a rank's local (k, n) at that
    many ranks (column n/tp, row k/tp where the dim divides; dense and
    GQA moe archs)."""
    from repro_torch.models import layer_kinds
    d, hd, H = cfg.d_model, cfg.head_dim_r, cfg.n_heads_p
    ta, tf, ts, tv = _tp_splits(cfg, tp)
    if cfg.use_mla:
        dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        attn = [(d, cfg.q_lora_rank), (cfg.q_lora_rank, H * (dn + dr)),
                (d, cfg.kv_lora_rank), (d, dr), (H * dv, d)]
        if not decode:
            attn += [(cfg.kv_lora_rank, H * dn), (cfg.kv_lora_rank, H * dv)]
    else:
        attn = [(d, H * hd // ta), (d, cfg.n_kv_p * hd // ta),
                (d, cfg.n_kv_p * hd // ta), (H * hd // ta, d)]
    out = collections.Counter()
    for kind in layer_kinds(cfg):
        if kind in ("mlstm", "slstm"):     # wi, wo; wi, wup, wo
            di, ff = int(cfg.mlstm_proj_factor * d), int(4 * d / 3)
            for kn in ([(d, 2 * di), (di, d)] if kind == "mlstm" else
                       [(d, 4 * d), (d, 2 * ff), (ff, d)]):
                out[kn] += 1
            continue
        ff = cfg.d_ff // tf if kind != "moe" else \
            cfg.n_shared_experts * cfg.d_ff_expert // ts
        gated = cfg.gated_mlp or kind == "moe"
        mlp = [(d, ff), (ff, d)] + ([(d, ff)] if gated else []) if ff else []
        ssm = []
        if kind == "hybrid":               # win, wbcdt, wout (wdt: plain)
            di = cfg.ssm_expand * d
            ssm = [(d, 2 * di), (di, max(1, d // 16) + 2 * cfg.ssm_state),
                   (di, d)]
        for kn in attn + mlp + ssm:
            out[kn] += 1
    if not cfg.tie_embeddings:
        out[(d, cfg.vocab_p // tv)] += 1
    return dict(out)


def _path_shapes(cfg, forwards, decode: bool = False, tp: int = 1):
    """Encoded-matmul launches by (m, k, n) of ``forwards`` ({m: model
    forwards with m rows per linear}), at ``tp`` ranks' local shapes."""
    want = collections.Counter()
    for m, times in forwards.items():
        for (k, n), c in _linear_shapes(cfg, decode, tp).items():
            want[(m, k, n)] += c * times
    return dict(want)


def _static_forwards(chunks, meta: int = 0):
    """Model forwards of a static serve by m, (prefill, decode): per
    chunk one prefill of batch·(seq + meta tokens) rows, and its decode
    steps plus the eager warm-up of each graph it captured at batch
    rows."""
    pre, dec = collections.Counter(), collections.Counter()
    for c in chunks:
        pre[c["batch"] * (c["seq"] + meta)] += 1
        dec[c["batch"]] += c["decode_steps"] + c["captures"]
    return pre, dec


def _static_shapes(cfg, chunks, tp=1):
    pre, dec = _static_forwards(chunks, cfg.meta_tokens)
    return dict(collections.Counter(_path_shapes(cfg, pre, tp=tp))
                + collections.Counter(_path_shapes(cfg, dec, decode=True,
                                                   tp=tp)))


def _check_static_counts(counts, chunks, cfg, where, gated=False, tp=1):
    """Kernel 1 at every linear of every forward of the static serve's
    ``chunks``, by (m, k, n), each of them gated in phases 3 where
    ``gated``; kernels 2 and 3 never (its attention is ``mha`` over the
    dense row)."""
    assert counts["encoded_matmul"] > 0, f"encoded_matmul not launched {where}"
    want = _static_shapes(cfg, chunks, tp)
    assert counts["encoded_matmul_by_shape"] == want, \
        f"encoded_matmul shapes {counts['encoded_matmul_by_shape']} != " \
        f"{want} {where}"
    assert counts["paged_attn"] == 0 and counts["flash_attention"] == 0, \
        f"kernel 2 or 3 launched {where}"
    if gated:
        _check_gated(counts, where)


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
        f"{info['seconds']['write']:.1f}s (kept for phase 6k's ranks)")
    fw = _fw_bytes(params_enc)
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
    _check_counts(counts, st, cfg, eng.prefill_chunk, "on the main path",
                  gated=True)
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
    _check_counts(counts_e, st_e, cfg, eager.prefill_chunk, "eagerly",
                  gated=True)
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
            "tokens": tokens, "stats": st, "bundle": cache}


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
                      f"with {mode} pools", gated=True)
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
                     "tokens": toks,
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
        while eng.metrics["prefills"] < N_SLOTS:
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


def graph_kernel_counts(graph) -> tuple:
    """The kernel-1/2/3 nodes of a captured CUDA graph, read from the graph
    itself: ``CUDAGraph.debug_dump`` (``cudaGraphDebugDotPrint``, verbose)
    writes every node with its kernel's name, and a replay runs exactly
    these nodes.  Needs a graph captured with ``keep_graph=True`` (``main``
    sets ``Step.keep_graph``).  Returns the counts by kind and the number
    of nodes."""
    import re
    path = os.path.join(ROOT, "build", f"graph-{os.getpid()}.dot")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    graph.debug_dump(path)
    if not os.path.exists(path):
        raise AssertionError("CUDAGraph.debug_dump wrote no file: the "
                             "graph was captured without keep_graph")
    with open(path) as f:
        text = f.read()
    os.remove(path)
    # a node's declaration starts its line; an edge's line starts
    # ``"graph_1_node_0" -> ...``
    nodes = re.split(r'(?m)^"graph_\d+_node_\d+"\s*\[', text)[1:]
    if not nodes:
        raise AssertionError(f"no node in the graph's dump: {text[:300]!r}")
    return ({k: sum(word in node for node in nodes)
             for k, word in GRAPH_KERNELS.items()}, len(nodes))


def _replay_split(step):
    """Device time of one replay of ``step``'s graph by kind of kernel
    (``torch.profiler``): kernel 1, kernel 2, the library's matrix
    products (the LM head) and every other kernel, in ms, with counts.
    Fails unless the graph holds each hand-written kernel as many times as
    the step adds to its launch counter per replay (``Step.delta``).  The
    count is read from the graph's own nodes (``graph_kernel_counts``),
    not from the profiler: a profiler capture can lose device events (on
    the H100 machine one capture of 2966 kernels came back with 2953, and
    in another run three captures in a row each lacked one of kernel 1's
    168), so its counts are only logged beside the graph's."""
    from repro_torch.launch.kernel_bench import cuda_kernel_times
    counted = {k: step.delta[k] for k in GRAPH_KERNELS}
    held, n_nodes = graph_kernel_counts(step.graph)
    out = collections.defaultdict(lambda: [0.0, 0])
    events = cuda_kernel_times(step.graph.replay)
    for name, us in events:
        kind = next((k for k, word in GRAPH_KERNELS.items() if word in name),
                    "library_gemm" if "gemm" in name.lower() else "other")
        out[kind][0] += us / 1e3
        out[kind][1] += 1
    total = sum(v[0] for v in out.values())
    log(f"[step] one {step.name} replay under torch.profiler: "
        f"{len(events)} device events of the graph's {n_nodes} nodes, "
        f"{total:.3f} ms of kernel time: "
        + ", ".join(f"{k} {v[0]:.3f} ms in {v[1]}"
                    for k, v in sorted(out.items())))
    seen = {k: out[k][1] if k in out else 0 for k in GRAPH_KERNELS}
    log(f"[step] {step.name} graph: kernels held (run per replay) {held}, "
        f"counted per replay {counted}: "
        f"{'equal' if held == counted else 'DIFFER'}; the profiler saw "
        f"{seen}")
    if held != counted:
        raise AssertionError(f"the {step.name} graph runs {held} kernels but "
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
                      f"with the prefix cache {'on' if on else 'off'}",
                      gated=True)
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
    return {"tokens": runs[True][0],
            "tok_s": {on: sum(map(len, r[0])) / r[1]
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
        _check_counts(counts, st, cfg, eng.prefill_chunk, f"({tag})",
                      gated=True)
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


def _overhead_serves(dev, params, cfg, trace, tokens, rounds: int = 3):
    """The main trace on graphed engines with telemetry off, with the
    trace on, and with the trace and ``time_device``: each engine serves
    it once (its graphs captured), then ``rounds`` more times, the three
    engines in turns; tok/s per repeat serve, step p50/p99 over them."""
    from repro_torch.obs import percentile
    from repro_torch.serve.telemetry import ServeTelemetry
    tags = {"off": {}, "trace": dict(trace=True),
            "trace+time_device": dict(trace=True, time_device=True)}
    engines, tok_s, steps = {}, collections.defaultdict(list), {}
    n_tok = sum(map(len, tokens))
    for rep in range(rounds + 1):
        for tag, kw in tags.items():
            if rep == 0:
                eng, rids = _serve(params, cfg, trace, dev,
                                   telemetry=ServeTelemetry(**kw))
                engines[tag] = eng
            else:
                eng = engines[tag]
                rids = [eng.submit(p, max_new=MAX_NEW) for p in trace]
            n0 = len(eng.step_ms)
            outs, dt, _, _ = _timed_run(eng, rids)
            if [outs[r].tolist() for r in rids] != tokens:
                raise AssertionError(f"telemetry {tag} changed the tokens")
            if rep:
                tok_s[tag].append(n_tok / dt)
                steps.setdefault(tag, []).extend(eng.step_ms[n0:])
    out = {}
    for tag in tags:
        out[tag] = {"tok_s": tok_s[tag],
                    "step_p50": percentile(steps[tag], 50),
                    "step_p99": percentile(steps[tag], 99)}
        log(f"[telemetry] overhead, telemetry {tag}: {rounds} repeat "
            f"serves in turns, tok/s {_spread(tok_s[tag])}; step p50 "
            f"{out[tag]['step_p50']:.3f} ms p99 {out[tag]['step_p99']:.3f} "
            f"ms over {len(steps[tag])} steps ({SMI})")
    del engines
    return out


def _reconcile(events, rids):
    """Largest |queued + prefill + decode - request| over the requests'
    tracks, in µs."""
    from repro_torch.serve.telemetry import req_tid
    worst = 0.0
    for rid in rids:
        mine = {e["name"]: e for e in events
                if e["ph"] == "X" and e["tid"] == req_tid(rid)}
        total = sum(mine[n]["dur"] for n in ("queued", "prefill", "decode"))
        worst = max(worst, abs(total - mine["request"]["dur"]))
    return worst


def phase_telemetry(dev, info):
    """Phase 6g: the serving telemetry and the allocator sanitizer on the
    main path (full-width qwen1.5-0.5b, the exact encoding, dense f32
    pools, graphed): (a) the trace traced, timed and sanitized; (b) with
    the drift monitor every 8 steps against the fp params; (c) spec
    decoding k = 4 with the monitor fed by verification; (d) the
    shared-prefix trace sanitized, with a page shared by a peer so a
    request copies it on write; (e) one serve under ``torch.profiler``;
    and the overhead of tracing and ``time_device``."""
    import torch
    from repro_torch.obs import DriftMonitor
    from repro_torch.obs.profile import TRACE_FILE
    from repro_torch.serve.telemetry import ServeTelemetry
    params, cfg = info["params_enc"], info["cfg_enc"]
    trace, tokens = info["trace"], info["tokens"]
    out = {"overhead": _overhead_serves(dev, params, cfg, trace, tokens)}
    # (a) traced, timed and sanitized
    tel = ServeTelemetry(trace=True, time_device=True)
    eng, rids = _serve(params, cfg, trace, dev, telemetry=tel, sanitize=True)
    outs, dt, counts, st = _timed_run(eng, rids)
    if [outs[r].tolist() for r in rids] != tokens:
        raise AssertionError("traced, timed, sanitized tokens differ")
    _check_counts(counts, st, cfg, eng.prefill_chunk,
                  "traced, timed and sanitized", gated=True)
    events = tel.tracer.chrome_events()
    worst = _reconcile(events, rids)
    n_dev = sum(e["name"] == "device:decode" for e in events)
    reg = tel.registry
    led = eng.kv.ledger
    log(f"[telemetry] (a) traced + timed + sanitized: {len(events)} trace "
        f"events, phases sum to each request span within {worst:.3f} us; "
        f"device:decode spans {n_dev} for {st['decode_steps']} decode "
        f"steps; device decode p50 {st['device_decode_ms_p50']:.3f} ms, "
        f"prefill p50 {st['device_prefill_ms_p50']:.3f} ms, step p50 "
        f"{st['step_ms_p50']:.3f} ms; ledger {led.ops} ops, {led.checks} "
        f"checks; jit_compiles "
        f"{reg.get('jit_compiles').series()}")
    if worst > 1.0:
        raise AssertionError(f"phases part from request spans by {worst} us")
    want = {"engine_steps": st["steps"], "decode_tokens": st["decode_tokens"],
            "prefill_chunks": st["prefill_chunks"],
            "prefills": st["prefills"], "admissions": st["admissions"],
            "stalls": st["stalls"], "rejects": st["rejects"]}
    got = {n: reg.counter(n).total() for n in want}
    hists = {"step_ms": st["steps"], "device_decode_ms": st["decode_steps"],
             "device_prefill_ms": st["prefill_chunks"]}
    got_h = {n: reg.histogram(n).count(mac=cfg.mac.mode) for n in hists}
    caps = {n: s.captures for n, s in eng.steps.items()}
    jit = {n: reg.counter("jit_compiles").value(fn=n) for n in caps}
    if not (n_dev == st["decode_steps"] and got == want and got_h == hists
            and jit == caps and st["device_decode_ms_p50"]
            <= st["step_ms_p50"] and led.ops > 0
            and led.checks >= st["steps"]):
        raise AssertionError(
            f"telemetry (a): device:decode {n_dev}, counters {got} against "
            f"{want}, histograms {got_h} against {hists}, jit_compiles "
            f"{jit} against captures {caps}, device p50 "
            f"{st['device_decode_ms_p50']} step p50 {st['step_ms_p50']}, "
            f"ledger {led.ops} ops {led.checks} checks")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="telemetry-", dir=os.path.join(ROOT,
                                                                "build"))
    tp, mp = os.path.join(tmp, "t.json"), os.path.join(tmp, "m.json")
    tel.write(trace_out=tp, metrics_out=mp)
    with open(tp) as f:
        n_written = len(json.load(f)["traceEvents"])
    with open(mp) as f:
        snap = json.load(f)
    log(f"[telemetry] (a) wrote {os.path.getsize(tp)} B of trace "
        f"({n_written} events) and {os.path.getsize(mp)} B of metrics "
        f"({sum(len(v) for v in snap.values())} metrics); both parse")
    assert n_written == len(events)
    assert snap["counters"]["engine_steps"]["series"][""] == st["steps"]
    shutil.rmtree(tmp)
    del eng
    # (b) the drift monitor against the fp params
    mon = DriftMonitor(info["params"], info["cfg"], every=DRIFT_EVERY,
                       max_len=DRIFT_MAX_LEN)
    sampled = collections.Counter()
    sample = mon.sample

    def counted(p, c, prompts):
        ms = [min(len(x), mon.max_len) for x in prompts
              if len(x)][:mon.max_prompts]
        res = sample(p, c, prompts)
        if res is not None:
            sampled.update(ms)
        return res

    mon.sample = counted
    tel = ServeTelemetry(drift=mon)
    eng, rids = _serve(params, cfg, trace, dev, telemetry=tel)
    outs, dt, counts, st = _timed_run(eng, rids)
    n_s = tel.registry.counter("drift_samples").total()
    log(f"[telemetry] (b) drift every {DRIFT_EVERY} steps: top-1 agreement "
        f"{st['encoded_drift_top1']:.4f}, |dlogit| {mon.last_delta:.4f} "
        f"(last sample), {n_s:.0f} samples, encoded forwards by m "
        f"{dict(sampled)}; {sum(map(len, tokens)) / dt:.1f} tok/s ({SMI})")
    if [outs[r].tolist() for r in rids] != tokens:
        raise AssertionError("the drift monitor changed the tokens")
    if not (0.0 <= st["encoded_drift_top1"] <= 1.0 and n_s > 0):
        raise AssertionError(f"drift gauge {st['encoded_drift_top1']}, "
                             f"{n_s} samples")
    _check_counts(counts, st, cfg, eng.prefill_chunk,
                  "with the drift monitor", gated=True, extra=sampled)
    out["drift"] = {"top1": st["encoded_drift_top1"],
                    "abs_logit": mon.last_delta, "samples": n_s}
    del eng
    # (c) spec decoding k = 4: drift from verification, no extra forward
    mon = DriftMonitor(info["params"], info["cfg"], every=DRIFT_EVERY)
    eng, rids = _serve(params, cfg, trace, dev, spec_decode=SPEC_K,
                       telemetry=ServeTelemetry(drift=mon))
    outs, dt, counts, st = _timed_run(eng, rids)
    ratio = st["spec_accepted_tokens"] / st["spec_draft_tokens"]
    k4 = info["spec"][f"self_k{SPEC_K}"]["counts"]["encoded_matmul"]
    log(f"[telemetry] (c) spec k={SPEC_K} with the drift monitor: gauge "
        f"{st['encoded_drift_top1']:.4f}, accepted/considered {ratio:.4f};"
        f" kernel 1 launches {counts['encoded_matmul']} (phase 6d k={SPEC_K}"
        f": {k4})")
    if [outs[r].tolist() for r in rids] != tokens:
        raise AssertionError("spec decoding with drift changed the tokens")
    if st["encoded_drift_top1"] != ratio or counts["encoded_matmul"] != k4:
        raise AssertionError("spec-decoding drift: gauge or launches off")
    _check_counts(counts, st, cfg, eng.prefill_chunk,
                  "spec decoding with the drift monitor", gated=True)
    del eng
    # (d) the shared-prefix trace under the ledger, with a copy-on-write
    ptrace = _prefix_trace(cfg.vocab_size)
    eng, rids = _serve(params, cfg, ptrace, dev, prefix_cache=True,
                       sanitize=True)
    torch.cuda.synchronize()
    _reset_counts()
    peer = None
    while eng.busy:
        eng.step()
        if peer is None:
            for r in eng.sched.active():
                if r.n_cached % PAGE_SIZE and len(r.out) < r.max_new - 2:
                    # a peer takes a reference to the page this request
                    # writes next: its next write copies the page
                    peer = r.pages[r.n_cached // PAGE_SIZE]
                    eng.kv.alloc.retain(peer)
                    break
    torch.cuda.synchronize()
    counts, st = _read_counts(), eng.stats()
    eng.kv.alloc.free([peer])
    eng.kv.ledger.verify()
    led = eng.kv.ledger
    res = eng.results()
    same = [res[r].tolist() for r in rids] == info["prefix"]["tokens"]
    log(f"[telemetry] (d) shared-prefix trace sanitized: copy-on-write "
        f"{st['cow_copies']}, hit tokens {st['prefix_hit_tokens']}, ledger "
        f"{led.ops} ops {led.checks} checks, tokens against phase 6c "
        f"{'identical' if same else 'DIFFERENT'}")
    if not (same and st["cow_copies"] > 0 and led.checks >= st["steps"]):
        raise AssertionError("prefix trace under the ledger")
    _check_counts(counts, st, cfg, eng.prefill_chunk,
                  "sanitized with the prefix cache", gated=True)
    del eng
    # (e) one serve under torch.profiler, graphs captured in it
    pdir = tempfile.mkdtemp(prefix="profile-", dir=os.path.join(ROOT,
                                                                "build"))
    eng, rids = _serve(params, cfg, trace[:2], dev, max_new=4,
                       telemetry=ServeTelemetry(profile_dir=pdir))
    eng.run()
    path = os.path.join(pdir, TRACE_FILE)
    with open(path) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    found = {k: sorted(n for n in names if word in n)[:1]
             for k, word in GRAPH_KERNELS.items()}
    log(f"[telemetry] (e) profiler dump {os.path.getsize(path)} B, "
        f"{len(names)} kernel names; kernels 1/2/3: {found}")
    shutil.rmtree(pdir)
    if not (found["encoded_matmul"] and found["paged_attn"]):
        raise AssertionError("the profiler dump names no kernel 1 or 2")
    del eng
    torch.cuda.empty_cache()
    return out


def _static(params, cfg, trace, device, max_new: int = MAX_NEW, **kw):
    """A ``ServeEngine`` over ``N_SLOTS``-request chunks and its counted
    run: (engine, tokens per request, seconds, launch counts)."""
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(params, cfg, batch_slots=N_SLOTS, device=device, **kw)
    return eng, *_static_run(eng, trace, max_new)


def _static_run(eng, trace, max_new: int = MAX_NEW):
    import torch
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    outs = eng.run(trace, max_new=max_new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return [o.tolist() for o in outs], dt, _read_counts()


def _routes(params, cfg, toks, dev):
    """The last position's logits of ``toks`` by three routes of one
    function: a no-cache forward (the static engine's prefill numerics);
    ``toks[:-1]`` prefilled into a dense cache and the last token decoded
    over the dense row (the static engine's decode); and ``toks[:-1]``
    prefilled into paged pools in 32-token chunks and the last token
    decoded through the fused paged op (the continuous engine's decode).
    Also how many of that token's int8 activation codes, over every
    encoded linear, differ from the no-cache route's in each other route."""
    import torch
    from repro_torch.models import apply_model, init_cache, init_paged_cache
    from repro_torch.nn.common import activation_recorder
    nodes = [params.get("lm_head", {})] + [
        sub for layer in params["layers"] for sub in layer.values()
        if isinstance(sub, dict)]
    sa = {id(node[k]): node[k + "_as"] for node in nodes for k in node
          if k + "_fw" in node}
    n = len(toks)
    x = torch.from_numpy(toks).to(dev)[None]
    codes = collections.defaultdict(list)

    def recorder(tag):
        def hook(name, w, inp):
            if id(w) in sa:
                codes[tag].append(torch.round(
                    inp[0, -1].float() / sa[id(w)]).clamp(-127, 127))
        return activation_recorder(hook)

    logits = {}
    with torch.inference_mode():
        with recorder("no-cache"):
            logits["no-cache"] = apply_model(params, cfg, x)[0]
        dense = init_cache(cfg, 1, n, device=dev)
        _, dense = apply_model(params, cfg, x[:, :n - 1], cache=dense)
        with recorder("dense"):
            logits["dense"] = apply_model(params, cfg, x[:, n - 1:],
                                          cache=dense)[0]
        P = -(-n // PAGE_SIZE) + 1
        paged = init_paged_cache(cfg, P + 1, PAGE_SIZE, device=dev)
        paged["pages"] = torch.arange(1, P + 1, dtype=torch.int32,
                                      device=dev)[None]
        for s0 in range(0, n - 1, 32):
            paged["lens"] = torch.full((1,), s0, dtype=torch.int32,
                                       device=dev)
            apply_model(params, cfg, x[:, s0:min(n - 1, s0 + 32)],
                        cache=paged)
        paged["lens"] = torch.full((1,), n - 1, dtype=torch.int32,
                                   device=dev)
        with recorder("paged"):
            logits["paged"] = apply_model(params, cfg, x[:, n - 1:],
                                          cache=paged)[0]
    flips = {t: sum(int((a != b).sum()) for a, b in
                    zip(codes["no-cache"], codes[t]))
             for t in ("dense", "paged")}
    V = cfg.vocab_size
    return {t: lg[0, -1, :V].float() for t, lg in logits.items()}, flips


def _split_origins(dev, params, cfg, trace, splits, a, b):
    """Where the static (``a``) and continuous (``b``) engines' tokens
    first part, for each split ``(i, j, _)`` of ``_split_report``: both
    engines run again eagerly (their graphed and eager tokens are gated
    identical) while a hook reads request ``i``'s input to every encoded
    linear over its activation scale, position by position (the prompt,
    then each token fed back): the whole trace through the continuous
    engine, and the request's chunk through a ``StaticBatch`` padded as
    ``ServeEngine`` pads it.  Logged per split: the first position, and
    the first linear in forward order there, where the two engines' int8
    codes differ; the values before rounding on both sides; how far apart
    every earlier input was; how many codes differ by the split; and the
    request served alone through the continuous engine.  A diagnosis,
    not a gate."""
    import numpy as np
    import torch
    from repro_torch.nn.common import activation_recorder
    from repro_torch.serve import supports_ragged_mask
    from repro_torch.serve.engine import StaticBatch, _ragged_pad
    from repro_torch.serve.scheduler import DECODING
    nodes = [("head", params.get("lm_head", {}))] + [
        (f"layer {li} {sub}", layer[sub])
        for li, layer in enumerate(params["layers"])
        for sub in ("attn", "mlp")]
    sites = {id(node[k]): (f"{where}/{k}", node[k + "_as"])
             for where, node in nodes for k in node if k + "_fw" in node}
    want = {i: j for i, j, _ in splits}
    order = []
    # (engine, request) → site → [(prefill?, rows of x / scale)]
    got = collections.defaultdict(lambda: collections.defaultdict(list))

    def recorder(engine, rows_of):
        def hook(name, w, x):
            if id(w) not in sites:
                return
            site, sa = sites[id(w)]
            if site not in order:
                order.append(site)
            for i, pre, rows in rows_of(x):
                got[(engine, i)][site].append((pre, rows.float() / sa))
        return activation_recorder(hook)

    eng, rids = _serve(params, cfg, trace, dev, cuda_graphs=False)
    cur = {}
    chunk_of = eng._prefill_chunk

    def prefill_chunk(req):
        cur["rid"] = req.rid
        chunk_of(req)
        cur.pop("rid")
    eng._prefill_chunk = prefill_chunk
    of_rid = {rids[i]: i for i in want}

    def cont_rows(x):
        if x.shape[1] > 1:                 # a (1, chunk) prefill chunk
            i = of_rid.get(cur.get("rid"))
            return [] if i is None else [(i, True, x[0])]
        return [(i, False, x[eng.requests[rids[i]].slot]) for i in want
                if eng.requests[rids[i]].state == DECODING]
    with torch.inference_mode(), recorder("continuous", cont_rows):
        outs = eng.run()
    cont = {i: outs[rids[i]].tolist() for i in want}
    chunk_len = eng.prefill_chunk
    del eng._prefill_chunk             # the wrapper's cycle would keep eng
    del eng
    static, shape_of = {}, {}
    for c0 in sorted({i - i % N_SLOTS for i in want}):
        chunk = trace[c0:c0 + N_SLOTS]
        S = max(map(len, chunk))
        batch = np.zeros((len(chunk), S), np.int32)
        pad = np.zeros((len(chunk),), np.int32)
        for r, p in enumerate(chunk):
            batch[r, S - len(p):] = p
            pad[r] = S - len(p)
        rows = {i - c0: i for i in want if c0 <= i < c0 + N_SLOTS}
        sb = StaticBatch(params, cfg, len(chunk), S + MAX_NEW + 8,
                         device=dev, graphs=False)

        def static_rows(x, rows=rows, pad=pad):
            if x.shape[1] > 1:             # the chunk's prefill
                return [(i, True, x[r, int(pad[r]):]) for r, i in rows.items()]
            return [(i, False, x[r]) for r, i in rows.items()]
        with torch.inference_mode(), recorder("static", static_rows):
            out = sb.run(torch.from_numpy(batch),
                         max(want[i] for i in rows.values()) + 1,
                         pad=_ragged_pad(cfg, pad)
                         if supports_ragged_mask(cfg) else None)
        static.update({i: out[r].tolist() for r, i in rows.items()})
        shape_of.update({i: (len(chunk), S) for i in rows.values()})
        del sb
    found = []
    for i, j in want.items():
        plen = len(trace[i])
        n_pos = plen + j                   # the prompt, then j tokens fed

        def series(engine):
            pieces = got[(engine, i)]
            return {site: torch.cat(
                [torch.cat([r for pre, r in pieces[site] if pre])[:plen]]
                + [r for pre, r in pieces[site] if not pre])[:n_pos]
                for site in order}
        xs, xc = series("static"), series("continuous")
        assert all(xs[t].shape[0] == n_pos == xc[t].shape[0] for t in order)

        def code(t):
            return torch.clamp(torch.round(t), -127, 127)
        diff = torch.stack([(code(xs[t]) != code(xc[t])).any(dim=1)
                            for t in order])               # (sites, pos)
        apart = torch.stack([(xs[t] != xc[t]).any(dim=1) for t in order])
        hit0 = apart.any(dim=0).nonzero()
        if len(hit0):                      # the first input apart at all
            p0 = int(hit0[0])
            t0 = order[int(apart[:, p0].nonzero()[0])]
            first = (f"the first input apart at all is {t0}'s at position "
                     f"{p0}, by up to "
                     f"{(xs[t0][p0] - xc[t0][p0]).abs().max().item():.3e}")
        else:
            first = "no input apart at all"
        n_codes = sum(int((code(xs[t]) != code(xc[t])).sum()) for t in order)
        same_s = static[i][:j + 1] == a[i][:j + 1]
        same_c = cont[i][:j + 1] == b[i][:j + 1]
        e1, r1 = _serve(params, cfg, [trace[i]], dev, max_new=j + 1)
        alone = e1.run()[r1[0]].tolist()
        del e1
        verdict = ("the batched continuous serve's" if alone == b[i][:j + 1]
                   else "the static serve's" if alone == a[i][:j + 1]
                   else "neither engine's")
        hit = diff.any(dim=0).nonzero()
        if len(hit) == 0:
            log(f"[split-origin] request {i}: no int8 code differs between "
                f"the engines up to new token {j} ({first}); eager tokens "
                f"the same as the serves' {same_s and same_c}; alone {alone} "
                f"({verdict})")
            found.append({"request": i, "position": None})
            continue
        p = int(hit[0])
        t = order[int(diff[:, p].nonzero()[0])]
        ch = int((code(xs[t][p]) != code(xc[t][p])).nonzero()[0])
        before = max([(xs[u][:p] - xc[u][:p]).abs().max().item()
                      for u in order if p] + [
            (xs[u][p] - xc[u][p]).abs().max().item()
            for u in order[:order.index(t)]] + [0.0])
        gap = (xs[t][p] - xc[t][p]).abs().max().item()
        edge = max(abs(v - math.floor(v) - 0.5)
                   for v in (xs[t][p, ch].item(), xc[t][p, ch].item()))
        B, S = shape_of[i]
        where = (f"prompt position {p} (the static engine's {B} x {S} "
                 f"prefill; the continuous engine's prefill chunk "
                 f"{p // chunk_len}, row {p % chunk_len})" if p < plen else
                 f"new token {p - plen} fed back (a decode step of each)")
        log(f"[split-origin] request {i} (prompt {plen}, parts at new token "
            f"{j}): the first int8 code that differs between the engines is "
            f"at {where}, {t} channel {ch}: x / scale "
            f"{xs[t][p, ch].item():.7f} (static) against "
            f"{xc[t][p, ch].item():.7f} (continuous), {edge:.1e} from the "
            f".5 boundary; that input row apart "
            f"by up to {gap:.3e}, every earlier input by up to {before:.3e} "
            f"(x / scale) with no code different ({first}); by the split "
            f"{n_codes} "
            f"codes differ at {int(diff.any(dim=0).sum())} of {n_pos} "
            f"positions. Eager tokens to the split equal the graphed "
            f"serves': static {same_s}, continuous {same_c}. Served alone "
            f"through the continuous engine: {alone} ({verdict})")
        found.append({"request": i, "position": p, "prompt": plen,
                      "site": t, "gap": gap, "before": before, "edge": edge,
                      "first": first,
                      "codes": n_codes, "alone": verdict})
    del got, sites
    gc.collect()
    torch.cuda.empty_cache()
    return found


def _split_report(params, cfg, trace, a, b, names, dev, rtol=None,
                  origins=False):
    """Greedy tokens of two engines over ``trace``: each request's first
    split, if any, logged with its position, the two candidates' logit
    margin under each route of ``_routes`` (which differ only in f32
    summation order), how far those routes' logits part and how many of
    the token's int8 activation codes differ between them.  With
    ``rtol``, every split must be a near-tie: a margin within ``rtol`` of
    the largest |logit| under every route.  Without it (encoded weights,
    where a flipped code in any earlier token moves later K/V by a code
    step, ROADMAP Queue C) the splits are reported, not gated; with
    ``origins`` (``a`` static, ``b`` continuous, ``trace`` the main one)
    ``_split_origins`` finds where each split starts, and each must start
    at a code moved across a rounding boundary by f32 order alone (within
    ``ORIGIN_TOL``), or, with no code moved, be a near-tie under
    ``FP_TIE_RTOL``."""
    import numpy as np
    splits = []
    for i, (x, y) in enumerate(zip(a, b)):
        j = next((j for j, (u, v) in enumerate(zip(x, y)) if u != v), None)
        if j is None:
            continue
        toks = np.concatenate([trace[i], np.asarray(x[:j], np.int32)])
        lg, flips = _routes(params, cfg, toks, dev)
        rs = list(lg.values())
        spread = max((p - q).abs().max().item() for p in rs for q in rs)
        margins = {t: (r[x[j]] - r[y[j]]).item() for t, r in lg.items()}
        top = max(r.abs().max().item() for r in rs)
        splits.append((i, j, max(map(abs, margins.values())) / top))
        log(f"[split] {names[0]} vs {names[1]}: request {i} (prompt "
            f"{len(trace[i])}) parts at new token {j}: {x[j]} against "
            f"{y[j]}; margin by route " + ", ".join(
                f"{t} {m:.3e}" for t, m in margins.items()) +
            f" ({splits[-1][2]:.2e} of max|logit| {top:.4f}); the routes' "
            f"logits apart by up to {spread:.3e}; int8 codes of that token "
            f"differing from the no-cache route's: {flips}")
    same = len(a) - len(splits)
    log(f"[split] {names[0]} vs {names[1]}: {same} of {len(a)} requests "
        f"token for token identical, {len(splits)} split" + (
            f" (gated: a split must be a near-tie within {rtol} of "
            f"max|logit|)" if rtol is not None else
            " (gated on where each starts)" if origins else
            " (reported, not gated)"))
    if origins and splits:
        rel = {i: r for i, _, r in splits}
        for o in _split_origins(dev, params, cfg, trace, splits, a, b):
            i = o["request"]
            if o["position"] is None:
                ok = rel[i] <= FP_TIE_RTOL
            else:
                ok = o["edge"] <= ORIGIN_TOL and o["before"] <= ORIGIN_TOL
            if not ok:
                raise AssertionError(
                    f"{names[0]} and {names[1]} part at request {i} without "
                    f"a rounding-boundary origin: {o}")
        log(f"[split] every split starts at a code that f32 order moved "
            f"across a .5 boundary (within {ORIGIN_TOL} of it, earlier "
            f"inputs within {ORIGIN_TOL})")
    for i, j, rel in splits:
        if rtol is not None and rel > rtol:
            raise AssertionError(
                f"{names[0]} and {names[1]} part at request {i} token {j} "
                f"with a margin of {rel:.2e} of max|logit|, not a near-tie "
                f"(<= {rtol})")
    return splits


def phase_static(dev, info):
    """Phase 6e: ``ServeEngine`` on the dense KV cache at full width and
    depth, the main trace in chunks of ``N_SLOTS``: graphed (fresh, then
    warm) and eager, identical tokens; against the continuous engine's
    tokens (identical or a near-tie); kernel 1 at every linear of every
    forward, kernel 2 never."""
    import numpy as np
    import torch
    params, cfg, trace = info["params_enc"], info["cfg_enc"], info["trace"]
    eng, toks, dt, counts = _static(params, cfg, trace, dev)
    st = eng.stats()
    n_tok = sum(map(len, toks))
    log(f"[static] {cfg.arch} {cfg.n_layers} layers: {st['chunks']} chunks "
        f"of {N_SLOTS}, {n_tok} tokens in {dt:.3f}s = {n_tok / dt:.1f} tok/s "
        f"(captures included: {st['jit_compiles_by_shape']}); decode steps "
        f"{st['decode_steps']}, step p50 {st['step_ms_p50']:.2f} ms p99 "
        f"{st['step_ms_p99']:.2f} ms (card timeline), dense cache "
        f"{st['kv_cache_bytes'] / 1e9:.3f} GB")
    log(f"[static] launches: encoded_matmul {counts['encoded_matmul']} by "
        f"(m, k, n) {counts['encoded_matmul_by_shape']}; paged_attn "
        f"{counts['paged_attn']} flash_attention {counts['flash_attention']}")
    assert st["cuda_graphs"] and st["chunks"] == 2 and all(
        v == 1 for v in st["jit_compiles_by_shape"].values()), \
        f"captures {st['jit_compiles_by_shape']}, not one per chunk shape"
    assert len(toks) == N_REQUESTS and all(len(t) == MAX_NEW for t in toks)
    assert all(0 <= t < cfg.vocab_size for x in toks for t in x)
    _check_static_counts(counts, eng.chunks, cfg, "in the static serve",
                         gated=True)
    warm = []
    for _ in range(2):
        n0, c0 = len(eng.step_ms), len(eng.chunks)
        toks2, dt2, counts2 = _static_run(eng, trace)
        assert toks2 == toks, "the warm static engine changed the tokens"
        _check_static_counts(counts2, eng.chunks[c0:], cfg,
                             "in the warm static serve", gated=True)
        warm.append((n_tok / dt2, float(np.percentile(eng.step_ms[n0:], 50))))
    log(f"[static] 2 more serves by the same engine (each chunk builds its "
        f"cache and captures its graph anew): tok/s "
        f"{', '.join(f'{w[0]:.1f}' for w in warm)}, step p50 "
        f"{', '.join(f'{w[1]:.2f}' for w in warm)} ms; captures in all "
        f"{eng.stats()['jit_compiles']}; tokens identical")
    eager, toks_e, dt_e, counts_e = _static(params, cfg, trace, dev,
                                            cuda_graphs=False)
    st_e = eager.stats()
    same = toks_e == toks
    log(f"[static] eager (cuda_graphs=False): {n_tok / dt_e:.1f} tok/s, step "
        f"p50 {st_e['step_ms_p50']:.2f} ms p99 {st_e['step_ms_p99']:.2f} ms; "
        f"greedy tokens graphs vs eager {'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("static engine: graphed and eager tokens differ")
    _check_static_counts(counts_e, eager.chunks, cfg, "eagerly", gated=True)
    del eager
    log(f"[static] beside the continuous engine (phase 6): tok/s fresh "
        f"{info['tok_s']:.1f} / static {n_tok / dt:.1f}, warm "
        f"{max(info['warm_tok_s']):.1f} / {max(w[0] for w in warm):.1f}, "
        f"eager {info['eager_tok_s']:.1f} / {n_tok / dt_e:.1f}")
    splits = _split_report(params, cfg, trace, toks, info["tokens"],
                           ("static", "continuous"), dev, origins=True)
    del eng
    # the two engines with the fp weights: no activation codes to move, so
    # the routes part by f32 rounding alone
    fp, fp_cfg = info["params"], info["cfg"]
    eng, rids = _serve(fp, fp_cfg, trace, dev)
    outs, _, _, _ = _timed_run(eng, rids)
    del eng
    seng, toks_fp, _, _ = _static(fp, fp_cfg, trace, dev)
    del seng
    fp_splits = _split_report(fp, fp_cfg, trace, toks_fp,
                              [outs[r].tolist() for r in rids],
                              ("static fp", "continuous fp"), dev,
                              rtol=FP_TIE_RTOL)
    torch.cuda.empty_cache()
    return {"counts": counts, "tok_s": n_tok / dt, "tokens": toks,
            "warm_tok_s": [w[0] for w in warm],
            "eager_tok_s": n_tok / dt_e, "step_p50": st["step_ms_p50"],
            "warm_step_p50": [w[1] for w in warm],
            "eager_step_p50": st_e["step_ms_p50"], "splits": len(splits),
            "fp_splits": len(fp_splits)}


def _fold_exact(params, cfg):
    """Calibrate and fold ``params`` on their device with the exact
    encoding, as ``prepare_encoded_serving`` does, without writing a
    bundle (tens of GB at these widths): (params_enc, cfg_enc, seconds)."""
    import torch
    from repro_torch.core.layers import MacConfig
    from repro_torch.serve import (arch_families, capture_activation_stats,
                                   exact_encodings, fold_linear_params)
    from repro_torch.serve.encoded import _merge
    macs = exact_encodings(cfg.mac.bits, arch_families(cfg))
    t0 = time.perf_counter()
    stats = capture_activation_stats(params, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    delta = fold_linear_params(params, stats, macs, cfg.mac.bits)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cfg_enc = dataclasses.replace(cfg, mac=MacConfig(
        mode="encoded_infer", bits=cfg.mac.bits, macs=macs))
    return _merge(params, delta), cfg_enc, (t1 - t0, t2 - t1)


def _long_request(dev, params, cfg, vocab):
    """gemma2's long request: one prompt of ``LONG_PROMPT`` tokens through
    the continuous engine (graphed, kernel 2), past layer 0's window.
    Once its prefill is done, kernel 2 on the live layer-0 pools against
    its plain version with the window, and against itself without it (the
    window must mask keys); then decode, and the static engine's tokens
    for the same request (identical or a near-tie)."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.counts import launch_counts, set_launch_counts
    from repro_torch.nn.attention import kv_of_q_map
    from repro_torch.serve import Engine
    from repro_torch.serve.scheduler import DECODING
    win = cfg.layer_windows[0]
    assert win is not None and LONG_PROMPT > win
    prompt = [np.random.default_rng(7).integers(0, vocab, LONG_PROMPT)
              .astype(np.int32)]
    new = 8
    seq_pages = -(-(LONG_PROMPT + new) // PAGE_SIZE) + 3      # 266
    eng = Engine(params, cfg, n_slots=N_SLOTS, page_size=PAGE_SIZE,
                 n_pages=seq_pages + 8, max_seq_pages=seq_pages, device=dev)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    rid = eng.submit(prompt[0], max_new=new)
    req = eng.requests[rid]
    while req.state != DECODING:
        eng.step()
    # kernel 2 on the live pools (not counted: a comparison, not the path)
    before = launch_counts()
    layer = eng.kv.layers[0]
    pages = torch.from_numpy(eng.kv.ptab).to(dev)
    lens = torch.from_numpy(eng.kv.lens).to(dev)
    q = torch.randn((N_SLOTS, 1, cfg.n_heads_p, cfg.head_dim_r),
                    generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    kv_map = kv_of_q_map(cfg.n_heads, cfg.n_kv_heads, cfg.n_heads_p,
                         cfg.n_kv_p)
    kw = dict(scale=cfg.attn_scale, cap=cfg.attn_softcap)
    G = cfg.n_heads_p // cfg.n_kv_p
    out = pa.paged_attn(q, layer["pool_k"], layer["pool_v"], pages, lens,
                        window=win, kv_of_q=kv_map, **kw)
    glob = pa.paged_attn(q, layer["pool_k"], layer["pool_v"], pages, lens,
                         kv_of_q=kv_map, **kw)
    ref = pa.paged_attn_plain(q, layer["pool_k"], layer["pool_v"], pages,
                              lens, win, G=G, **kw)
    torch.cuda.synchronize()
    set_launch_counts(before)
    s = req.slot
    err = (out - ref).abs().max().item()
    moved = (out[s] - glob[s]).abs().max().item()
    log(f"[archs] {cfg.arch} long request: prefill of {LONG_PROMPT} tokens "
        f"in {eng.metrics['prefill_chunks']} chunks, lens {int(lens[s])}, "
        f"table of {eng.kv.max_seq_pages} pages; kernel 2 on the live layer-0"
        f" pools with window {win}, softcap {cfg.attn_softcap}: max_abs_err "
        f"vs plain {err:.3e}; the window moves the row's output by {moved:.3e}")
    if not (torch.allclose(out, ref, rtol=1e-4, atol=1e-5) and moved > 1e-4):
        raise AssertionError("kernel 2's window on the live pools: plain "
                             f"error {err:.3e}, moved {moved:.3e}")
    outs = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _read_counts()
    st = eng.stats()
    _check_counts(counts, st, cfg, eng.prefill_chunk, "on the long request",
                  gated=True)
    cont = [outs[rid].tolist()]
    log(f"[archs] {cfg.arch} long request served in {dt:.2f}s: "
        f"{st['decode_steps']} decode steps, paged_attn by Sq "
        f"{counts['paged_attn_by_sq']}; tokens {cont[0]}")
    del eng
    seng, static, _, counts_s = _static(params, cfg, prompt, dev,
                                        max_new=new)
    _check_static_counts(counts_s, seng.chunks, cfg, "on the long request",
                         gated=True)
    del seng
    splits = _split_report(params, cfg, prompt, static, cont,
                           ("static", "continuous"), dev)
    torch.cuda.empty_cache()
    return {"seconds": dt, "splits": len(splits)}


def phase_archs(dev):
    """Phase 6f: each other dense arch at full width and cut depth, weights
    drawn on the card from seed 0 (gemma2-27b's took 21 s on the host),
    calibrated and folded on the card with the exact encoding,
    serving the main trace through the continuous engine (fused kernel 2)
    and ``ServeEngine``, each graphed and eager."""
    import torch
    from repro_torch.models import init_model
    out = {}
    for arch, depth in ARCH_DEPTHS:
        cfg = _arch_cfg(arch, depth)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_model(cfg, seed=0, device=dev, init_device=dev)
        t_init = time.perf_counter() - t0
        params_enc, cfg_enc, (t_cal, t_fold) = _fold_exact(params, cfg)
        fw = _fw_bytes(params_enc)
        log(f"[archs] {arch}: {cfg.n_layers} of {_arch_cfg(arch).n_layers} "
            f"layers, d={cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads}x"
            f"{cfg.head_dim_r} ff={cfg.d_ff} vocab={cfg.vocab_size} windows "
            f"{cfg.layer_windows}; init {t_init:.1f}s, calibration "
            f"{t_cal:.1f}s, fold {t_fold:.1f}s; folded bf16 Wt "
            f"{fw / 1e9:.3f} GB; device memory "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB")
        trace = make_trace(cfg.vocab_size)
        res = {}
        for graphs in (True, False):
            eng, rids = _serve(params_enc, cfg_enc, trace, dev,
                               cuda_graphs=graphs)
            outs, dt, counts, st = _timed_run(eng, rids)
            toks = [outs[r].tolist() for r in rids]
            assert len(toks) == N_REQUESTS and all(
                len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size for x in t)
                for t in toks), f"{arch}: not every request finished"
            _check_counts(counts, st, cfg_enc, eng.prefill_chunk,
                          f"({arch}, continuous)", gated=True)
            tag = "graphed" if graphs else "eager"
            res[("continuous", graphs)] = (toks, counts)
            log(f"[archs] {arch} continuous {tag}: "
                f"{sum(map(len, toks)) / dt:.1f} tok/s, step p50 "
                f"{st['step_ms_p50']:.2f} ms; launches encoded_matmul by "
                f"(m, k, n) {counts['encoded_matmul_by_shape']}, paged_attn "
                f"by Sq {counts['paged_attn_by_sq']}")
            del eng
            eng, toks, dt, counts = _static(params_enc, cfg_enc, trace, dev,
                                            cuda_graphs=graphs)
            st = eng.stats()
            _check_static_counts(counts, eng.chunks, cfg_enc,
                                 f"({arch}, static)", gated=True)
            res[("static", graphs)] = (toks, counts)
            log(f"[archs] {arch} static {tag}: "
                f"{sum(map(len, toks)) / dt:.1f} tok/s, step p50 "
                f"{st['step_ms_p50']:.2f} ms (captures "
                f"{st['jit_compiles']}); launches by (m, k, n) "
                f"{counts['encoded_matmul_by_shape']}")
            del eng
        for name in ("continuous", "static"):
            same = res[(name, True)][0] == res[(name, False)][0]
            log(f"[archs] {arch} {name}: greedy tokens graphs vs eager "
                f"{'identical' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"{arch} {name}: graphed and eager "
                                     "tokens differ")
        splits = _split_report(params_enc, cfg_enc, trace,
                               res[("static", True)][0],
                               res[("continuous", True)][0],
                               ("static", "continuous"), dev, origins=True)
        # the fp weights through both engines (graphed): a split only at
        # a near-tie
        eng, rids = _serve(params, cfg, trace, dev)
        outs, _, _, _ = _timed_run(eng, rids)
        del eng
        seng, toks_fp, _, _ = _static(params, cfg, trace, dev)
        del seng
        fp_splits = _split_report(params, cfg, trace, toks_fp,
                                  [outs[r].tolist() for r in rids],
                                  (f"{arch} static fp", "continuous fp"),
                                  dev, rtol=FP_TIE_RTOL)
        info = {"counts": res[("continuous", True)][1],
                "static_counts": res[("static", True)][1], "cfg": cfg_enc,
                "splits": len(splits), "fp_splits": len(fp_splits)}
        if arch == "gemma2-27b":
            info["long"] = _long_request(dev, params_enc, cfg_enc,
                                         cfg.vocab_size)
        log(f"[archs] {arch}: peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        out[arch] = info
        del params, params_enc
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _drop_tally(on: bool):
    """While ``on``: each MoE call's dropped (token, choice) pairs,
    recomputed from its routing plan (``nn.moe.dispatch_plan``), as
    (device count, pairs) in a list; eager serves only (a graph replay
    runs no Python)."""
    import repro_torch.nn.moe as M
    tally, orig = [], M.dispatch_plan

    def counted(idx, n_experts, cap):
        plan = orig(idx, n_experts, cap)
        tally.append(((~plan[2]).sum(), plan[2].numel()))
        return plan
    if on:
        M.dispatch_plan = counted
    try:
        yield tally
    finally:
        M.dispatch_plan = orig


def _drops(tally):
    """(dropped pairs, pairs) of a ``_drop_tally``, or None if empty."""
    if not tally:
        return None
    return (int(sum(int(d) for d, _ in tally)), sum(n for _, n in tally))


def _fw_bytes(tree) -> int:
    """Bytes of every folded ``*_fw`` leaf of a param tree."""
    if isinstance(tree, list):
        return sum(map(_fw_bytes, tree))
    return sum(_fw_bytes(v) if isinstance(v, (dict, list)) else
               (v.numel() * v.element_size() if k.endswith("_fw") else 0)
               for k, v in tree.items())


def _agreement(a, b):
    """Requests of two engines' tokens that are identical, and where the
    others first part (request, new token)."""
    parts = [(i, next(j for j, (u, v) in enumerate(zip(x, y)) if u != v))
             for i, (x, y) in enumerate(zip(a, b)) if x != y]
    return len(a) - len(parts), parts


def _moe_serves(dev, cfg, weights, trace):
    """The serves of one moe arch (phase 6h): for each of ``weights``
    ({"exact"/"fp": (params, cfg)}) the continuous engine (where the arch
    pages; dense f32, int8 and int4 pools for the exact encoding, dense
    for fp) and ``ServeEngine``, each graphed and eager, and the graphed
    dense-pool and static serves once more on the same engine.  Gates:
    every request finished; kernel 1 and 2 launches as the forwards make
    them (kernel 1 at gated shapes only), flash never; graphed = eager;
    repeat = first."""
    from repro_torch.models import supports_paged_cache
    pages = supports_paged_cache(cfg)
    res = {}
    for wname, (p, c) in weights.items():
        kvs = (("bf16", "int8", "int4") if wname == "exact" else ("bf16",)) \
            if pages else ()
        for graphs in (True, False):
            tag = f"{cfg.arch} {wname} {'graphed' if graphs else 'eager'}"
            for kv in kvs:
                ck = dataclasses.replace(c, kv_cache_dtype=kv)
                with _drop_tally(not graphs) as tally:
                    eng, rids = _serve(p, ck, trace, dev, cuda_graphs=graphs)
                    outs, dt, counts, st = _timed_run(eng, rids)
                toks = [outs[r].tolist() for r in rids]
                _finished(toks, cfg, tag)
                where = f"({tag}, continuous, kv {kv})"
                if wname == "exact":
                    _check_counts(counts, st, ck, eng.prefill_chunk, where,
                                  gated=True)
                else:
                    _check_fp_counts(counts, st, ck, eng.prefill_chunk, where)
                rep = None
                if graphs and kv == "bf16":
                    rids2 = [eng.submit(q, max_new=MAX_NEW) for q in trace]
                    outs2 = eng.run()
                    rep = [outs2[r].tolist() for r in rids2] == toks
                    if not rep:
                        raise AssertionError(f"{where}: a repeat serve on "
                                             "the same engine differs")
                res[("continuous", wname, kv, graphs)] = (toks, counts)
                res[("tok_s", "continuous", wname, kv, graphs)] = \
                    sum(map(len, toks)) / dt
                log(f"[moe] {tag} continuous kv {kv}: "
                    f"{sum(map(len, toks)) / dt:.1f} tok/s, step p50 "
                    f"{st['step_ms_p50']:.2f} ms, {st['decode_steps']} decode"
                    f" steps, {st['prefill_chunks']} prefill chunks; "
                    f"launches kernel 1 {counts['encoded_matmul']}, kernel 2"
                    f" by Sq {counts['paged_attn_by_sq']}, flash "
                    f"{counts['flash_attention']}" + (
                        f"; MoE drops {_drops(tally)} (pairs dropped, pairs)"
                        if not graphs else "") + (
                        "; repeat serve identical" if rep else ""))
                if not graphs:
                    res[("drops", "continuous", wname, kv)] = _drops(tally)
                del eng
            with _drop_tally(not graphs) as tally:
                eng, toks, dt, counts = _static(p, c, trace, dev,
                                                cuda_graphs=graphs)
            st = eng.stats()
            _finished(toks, cfg, tag)
            where = f"({tag}, static)"
            if wname == "exact":
                _check_static_counts(counts, eng.chunks, c, where, gated=True)
            else:
                assert counts["encoded_matmul"] == 0 and \
                    counts["paged_attn"] == 0 and \
                    counts["flash_attention"] == 0, f"kernels launched {where}"
            rep = None
            if graphs:
                rep = _static_run(eng, trace)[0] == toks
                if not rep:
                    raise AssertionError(f"{where}: a repeat serve on the same"
                                         " engine differs")
            if not graphs:
                res[("drops", "static", wname)] = _drops(tally)
            res[("static", wname, graphs)] = (toks, counts)
            res[("tok_s", "static", wname, graphs)] = \
                sum(map(len, toks)) / dt
            log(f"[moe] {tag} static: {sum(map(len, toks)) / dt:.1f} tok/s, "
                f"step p50 {st['step_ms_p50']:.2f} ms (captures "
                f"{st['jit_compiles']}, chunks {[(ch['batch'], ch['seq']) for ch in eng.chunks]}); "
                f"launches kernel 1 by (m, k, n) "
                f"{counts['encoded_matmul_by_shape']}" + (
                    f"; MoE drops {_drops(tally)}" if not graphs else "") + (
                    "; repeat serve identical" if rep else ""))
            del eng
    for key in [k for k in res if k[0] not in ("drops", "tok_s")
                and k[-1] is True]:
        same = res[key][0] == res[key[:-1] + (False,)][0]
        log(f"[moe] {cfg.arch} {key[:-1]}: greedy tokens graphed vs "
            f"eager {'identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{cfg.arch} {key[:-1]}: graphed and "
                                 "eager tokens differ")
    for wname in weights:
        if pages:
            n_same, parts = _agreement(res[("static", wname, True)][0],
                                       res[("continuous", wname, "bf16",
                                            True)][0])
            log(f"[moe] {cfg.arch} {wname}: static vs continuous (not gated:"
                " each call's capacity depends on its padded B·S) "
                f"{n_same} of {len(trace)} requests identical, parts "
                f"(request, new token) {parts}; MoE drops (pairs dropped, "
                f"pairs) static {res[('drops', 'static', wname)]}, "
                f"continuous {res[('drops', 'continuous', wname, 'bf16')]}")
        else:
            log(f"[moe] {cfg.arch} {wname}: MoE drops of the static serve "
                f"(pairs dropped, pairs) {res[('drops', 'static', wname)]}")
    return res


def _moe_cache_spec(dev, cfg, params, trace, res):
    """Phase 6h's prefix cache and speculative decoding on a paged moe
    arch (the exact encoding, dense f32 pools): the shared-prefix trace of
    6c with the cache on and off, and the main trace with spec decoding at
    k = ``SPEC_K`` (``self`` drafter); each graphed and eager (identical
    tokens), the graphed engine serving again (identical with the cache
    off; with the cache on or spec decoding logged only: a warm index hits
    every prompt, and a round's non-decoding rows attend over stale
    positions, so the repeat routes other MoE batches); launches as
    the forwards make them, at gated shapes; the draft and verify graphs'
    kernel nodes equal to what a replay counts (the MoE dispatch captured
    beside kernels 1 and 2).  Each call's capacity follows its own padded
    B·S, so cache on vs off and spec vs plain (``res``: the plain serve of
    ``_moe_serves``) are logged with the eager runs' MoE drops and gated
    as identical only where both drop 0 pairs."""
    out = {}
    ptrace = _prefix_trace(cfg.vocab_size)
    for name, tr, kw in (("prefix off", ptrace, {}),
                         ("prefix on", ptrace, dict(prefix_cache=True)),
                         (f"spec k={SPEC_K}", trace,
                          dict(spec_decode=SPEC_K))):
        for graphs in (True, False):
            tag = f"{cfg.arch} exact {name} {'graphed' if graphs else 'eager'}"
            with _drop_tally(not graphs) as tally:
                eng, rids = _serve(params, cfg, tr, dev, cuda_graphs=graphs,
                                   **kw)
                outs, dt, counts, st = _timed_run(eng, rids)
            toks = [outs[r].tolist() for r in rids]
            _finished(toks, cfg, tag)
            _check_counts(counts, st, cfg, eng.prefill_chunk, f"({tag})",
                          gated=True)
            if kw.get("prefix_cache") and st["prefix_hit_tokens"] <= 0:
                raise AssertionError(f"{tag}: no prefix hit")
            note = ""
            if graphs:
                rids2 = [eng.submit(q, max_new=MAX_NEW) for q in tr]
                outs2 = eng.run()
                toks2 = [outs2[r].tolist() for r in rids2]
                if kw:
                    # not gated: with the cache on, the warm index hits
                    # every prompt's cached pages, so the repeat prefills
                    # other suffixes; under spec decoding the rows of
                    # slots that do not decode in a round attend over
                    # their pages' stale positions, which the first serve
                    # found zeroed; either way other MoE batches
                    n2, p2 = _agreement(toks2, toks)
                    note = (f"; repeat serve (prefix hits "
                            f"{eng.stats()['prefix_hit_tokens']}) {n2} of "
                            f"{len(toks)} identical, parts {p2} (logged)")
                elif toks2 != toks:
                    raise AssertionError(f"{tag}: a repeat serve on the "
                                         "same engine differs")
                else:
                    note = "; repeat serve identical"
                if "spec_decode" in kw:
                    for step in ("draft", "verify"):
                        _replay_split(eng.steps[step])
            drops = None if graphs else _drops(tally)
            log(f"[moe] {tag}: {sum(map(len, toks)) / dt:.1f} tok/s, step "
                f"p50 {st['step_ms_p50']:.2f} ms, prefill tokens "
                f"{st['prefill_tokens']} in {st['prefill_chunks']} chunks, "
                f"prefix hits {st['prefix_hit_tokens']}" + (
                    f", {st['spec_rounds']} spec rounds, acceptance "
                    f"{st['spec_acceptance_rate']:.3f}"
                    if "spec_decode" in kw else "")
                + f"; launches kernel 1 {counts['encoded_matmul']}, kernel 2 "
                f"by Sq {counts['paged_attn_by_sq']}, flash "
                f"{counts['flash_attention']}" + (
                    f"; MoE drops {drops} (pairs dropped, pairs)"
                    if drops else "") + note)
            out[(name, graphs)] = {"tokens": toks, "counts": counts,
                                   "stats": st, "drops": drops,
                                   "tok_s": sum(map(len, toks)) / dt}
            del eng
        same = out[(name, True)]["tokens"] == out[(name, False)]["tokens"]
        log(f"[moe] {cfg.arch} {name}: greedy tokens graphed vs eager "
            f"{'identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{cfg.arch} {name}: graphed and eager "
                                 "tokens differ")
    plain = {"tokens": res[("continuous", "exact", "bf16", True)][0],
             "drops": res[("drops", "continuous", "exact", "bf16")]}
    for a, b in ((out[("prefix on", False)], out[("prefix off", False)]),
                 (out[(f"spec k={SPEC_K}", False)], plain)):
        n_same, parts = _agreement(a["tokens"], b["tokens"])
        no_drop = a["drops"][0] == 0 and b["drops"][0] == 0
        what = ("cache on vs off" if b is not plain
                else f"spec k={SPEC_K} vs plain")
        log(f"[moe] {cfg.arch} {what}: {n_same} of {len(a['tokens'])} "
            f"requests identical, parts (request, new token) {parts}; MoE "
            f"drops {a['drops']} vs {b['drops']}"
            + (" (both 0: gated)" if no_drop else " (not gated: capacity "
               "follows each call's padded B·S)"))
        if no_drop and parts:
            raise AssertionError(f"{cfg.arch} {what}: tokens differ with no "
                                 "pair dropped")
    return out


def _finished(toks, cfg, where):
    assert len(toks) == N_REQUESTS and all(
        len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size for x in t)
        for t in toks), f"{where}: not every request finished"


def _check_fp_counts(counts, st, cfg, chunk_len, where):
    """fp weights on the continuous engine: kernel 2 once per layer per
    decode forward, kernels 1 and 3 never."""
    _, attn = _forwards(st, chunk_len)
    want = {sq: cfg.n_layers * n for sq, n in attn.items()}
    assert counts["paged_attn_by_sq"] == want, \
        f"paged_attn by Sq {counts['paged_attn_by_sq']} != {want} {where}"
    assert counts["encoded_matmul"] == 0 and \
        counts["flash_attention"] == 0, f"kernel 1 or 3 launched {where}"


def phase_moe(dev):
    """Phase 6h: the moe family at full width and cut depth
    (``MOE_ARCHS``), weights from seed 0 drawn on the card, the exact
    encoding calibrated and folded there (no bundle write): qwen3-moe on
    both engines, deepseek-v3 (MLA: no paging) on ``ServeEngine``; fp
    weights too (``_moe_serves``); qwen3-moe's prefix cache and spec
    decoding (``_moe_cache_spec``); peak device memory per arch."""
    import torch
    from repro_torch.models import init_model, supports_paged_cache
    out = {}
    for arch, _, _ in MOE_ARCHS:
        cfg = _moe_cfg(arch)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_model(cfg, seed=0, device=dev, init_device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        params_enc, cfg_enc, (t_cal, t_fold) = _fold_exact(params, cfg)
        log(f"[moe] {arch}: {cfg.n_layers} of {_arch_cfg(arch).n_layers} "
            f"layers ({cfg.first_k_dense} dense), d={cfg.d_model}, "
            f"experts {cfg.n_experts} top-{cfg.top_k} ff {cfg.d_ff_expert} "
            f"+ {cfg.n_shared_experts} shared, router {cfg.router_type}, "
            f"mla {cfg.use_mla}, vocab {cfg.vocab_size}; weights "
            f"{cfg.param_dtype}, compute {cfg.compute_dtype}; init on the "
            f"card {t_init:.1f}s, calibration {t_cal:.1f}s, fold "
            f"{t_fold:.1f}s; folded bf16 Wt {_fw_bytes(params_enc) / 1e9:.3f}"
            f" GB; device memory {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
            f" GB; {SMI}")
        trace = make_trace(cfg.vocab_size)
        res = _moe_serves(dev, cfg, {"exact": (params_enc, cfg_enc),
                                     "fp": (params, cfg)}, trace)
        cache_spec = None
        if supports_paged_cache(cfg):
            cache_spec = _moe_cache_spec(dev, cfg_enc, params_enc, trace, res)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"[moe] {arch}: peak device memory {peak / 1e9:.2f} GB, "
            f"phase 6h part {time.perf_counter() - t0:.1f}s")
        if peak >= 80e9:
            raise AssertionError(f"{arch}: peak device memory {peak / 1e9} GB")
        cont = res.get(("continuous", "exact", "bf16", True))
        out[arch] = {"cfg": cfg_enc, "peak_gb": peak / 1e9,
                     "counts": cont[1] if cont else None,
                     "static_counts": res[("static", "exact", True)][1],
                     "paged": {kv: res[("continuous", "exact", kv, True)][1][
                         "paged_attn"] for kv in ("bf16", "int8", "int4")
                         if ("continuous", "exact", kv, True) in res},
                     "spec_counts": cache_spec[(f"spec k={SPEC_K}", True)][
                         "counts"] if cache_spec else None}
        if arch == "qwen3-moe-235b-a22b":       # phase 6k's baselines
            out[arch]["eager"] = {
                "continuous": res[("continuous", "exact", "bf16", False)][0],
                "static": res[("static", "exact", False)][0],
                "drops_continuous": res[("drops", "continuous", "exact",
                                         "bf16")],
                "drops_static": res[("drops", "static", "exact")],
                "eager_tok_s": {
                    "continuous": res[("tok_s", "continuous", "exact",
                                       "bf16", False)],
                    "static": res[("tok_s", "static", "exact", False)]}}
        del params, params_enc, res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_new_archs(dev):
    """Phase 6i: phi-3-vision-4.2b and hymba-1.5b (``NEW_ARCHS``) at full
    width, 4 of 32 layers (hymba: layer 0 global, layers 1-3 windowed at
    2048), through ``_serve_static_arch``: exact encoding and fp, graphed,
    eager and a repeat serve."""
    return {arch: _serve_static_arch(dev, arch, _new_cfg(arch), "new")
            for arch, _ in NEW_ARCHS}


def _serve_static_arch(dev, arch, cfg, tag, extra=None):
    """An arch that cannot page at full width with its depth cut, weights
    drawn on the card, the exact encoding calibrated and folded there (no
    bundle write): the main trace through ``ServeEngine``, with and
    without the encoding, graphed and eager (identical tokens), the
    graphed engine once more (identical); kernel 1 at every linear of
    every forward (a meta-token arch's static prefills at m = 4·(S +
    meta)) at gated shapes, kernels 2 and 3 never; folded bytes, peak
    memory, step p50 and tok/s.  ``extra(params_enc, cfg_enc, trace)``
    runs before the params go and adds its dict to the result."""
    import torch
    from repro_torch.models import init_model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=dev, init_device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    params_enc, cfg_enc, (t_cal, t_fold) = _fold_exact(params, cfg)
    fw = _fw_bytes(params_enc)
    log(f"[{tag}] {arch}: {cfg.n_layers} of {_arch_cfg(arch).n_layers} "
        f"layers, family {cfg.family}, d={cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim_r} ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} tied head {cfg.tie_embeddings}, "
        f"windows {cfg.layer_windows}, meta tokens {cfg.meta_tokens}, "
        f"ssm state {cfg.ssm_state}, patches {cfg.n_patches}, slstm every "
        f"{cfg.slstm_every}; init on the card {t_init:.1f}s, calibration "
        f"{t_cal:.1f}s, fold {t_fold:.1f}s; folded bf16 Wt "
        f"{fw / 1e9:.3f} GB; {SMI}")
    trace = make_trace(cfg.vocab_size)
    res = {}
    for wname, (p, c) in (("exact", (params_enc, cfg_enc)),
                          ("fp", (params, cfg))):
        for graphs in (True, False):
            what = f"{arch} {wname} {'graphed' if graphs else 'eager'}"
            eng, toks, dt, counts = _static(p, c, trace, dev,
                                            cuda_graphs=graphs)
            st = eng.stats()
            _finished(toks, cfg, what)
            where = f"({what}, static)"
            if wname == "exact":
                _check_static_counts(counts, eng.chunks, c, where,
                                     gated=True)
            else:
                assert counts["encoded_matmul"] == 0 and \
                    counts["paged_attn"] == 0 and \
                    counts["flash_attention"] == 0, \
                    f"kernels launched {where}"
            note = ""
            if graphs:
                if _static_run(eng, trace)[0] != toks:
                    raise AssertionError(f"{where}: a repeat serve on "
                                         "the same engine differs")
                note = "; repeat serve identical"
            res[(wname, graphs)] = (toks, counts, st,
                                    sum(map(len, toks)) / dt)
            log(f"[{tag}] {what} static: {sum(map(len, toks)) / dt:.1f} "
                f"tok/s, step p50 {st['step_ms_p50']:.2f} ms p99 "
                f"{st['step_ms_p99']:.2f} ms (captures "
                f"{st['jit_compiles']}, chunks "
                f"{[(ch['batch'], ch['seq']) for ch in eng.chunks]}, "
                f"dense cache {st['kv_cache_bytes'] / 1e6:.1f} MB); "
                f"launches kernel 1 by (m, k, n) "
                f"{counts['encoded_matmul_by_shape']}, kernel 2 "
                f"{counts['paged_attn']}, flash "
                f"{counts['flash_attention']}{note}")
            del eng
        same = res[(wname, True)][0] == res[(wname, False)][0]
        log(f"[{tag}] {arch} {wname}: greedy tokens graphed vs eager "
            f"{'identical' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{arch} {wname}: graphed and eager "
                                 "tokens differ")
    n_same, parts = _agreement(res[("exact", True)][0], res[("fp", True)][0])
    out = {"cfg": cfg_enc, "static_counts": res[("exact", True)][1],
           "fw_gb": fw / 1e9,
           "rows": {k: (v[2]["step_ms_p50"], v[3]) for k, v in res.items()}}
    if extra is not None:
        out.update(extra(params_enc, cfg_enc, trace))
    peak = torch.cuda.max_memory_allocated(dev)
    out["peak_gb"] = peak / 1e9
    log(f"[{tag}] {arch}: exact encoding vs fp weights {n_same} of "
        f"{len(trace)} requests identical, parts {parts} (logged); peak "
        f"device memory {peak / 1e9:.2f} GB, part "
        f"{time.perf_counter() - t0:.1f}s")
    del params, params_enc, res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _slstm_share(dev, params, cfg, trace):
    """The sLSTM block's share of a static prefill at the trace's first
    chunk (batch x its longest prompt, eager): the model's cached prefill
    and the sLSTM block alone on an input of that shape, each the median
    of 3 timed calls (CUDA events)."""
    import numpy as np
    import torch
    from repro_torch.models import init_cache, layer_kinds
    from repro_torch.nn import blocks as B
    from repro_torch.nn.xlstm import init_slstm_cache
    chunk = trace[:N_SLOTS]
    S = max(map(len, chunk))
    toks = np.zeros((len(chunk), S), np.int32)
    for r, q in enumerate(chunk):
        toks[r, S - len(q):] = q
    toks = torch.from_numpy(toks).to(dev)
    i_s = layer_kinds(cfg).index("slstm")
    x = torch.randn((len(chunk), S, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))

    def full():
        from repro_torch.models import apply_model
        apply_model(params, cfg, toks,
                    cache=init_cache(cfg, len(chunk), S + 1, device=dev))

    def slstm():
        B.slstm_block_apply(params["layers"][i_s], x, cfg,
                            cache=init_slstm_cache(cfg, len(chunk), 1,
                                                   device=dev)[0])
    with torch.inference_mode():
        full()
        slstm()
        t_full = sorted(_time_once(full, ()) for _ in range(3))[1]
        t_s = sorted(_time_once(slstm, ()) for _ in range(3))[1]
    log(f"[xw] {XLSTM_ARCH} exact static prefill of ({len(chunk)}, {S}) "
        f"tokens, eager: {t_full:.2f} ms; its sLSTM block alone "
        f"{t_s:.2f} ms, a share of {t_s / t_full:.3f} ({S} sequential "
        f"steps); {SMI}")
    return {"prefill_ms": t_full, "slstm_ms": t_s, "share": t_s / t_full,
            "prefill_shape": (len(chunk), S)}


def _whisper_prompts(cfg, B=N_SLOTS, S=64, seed=0):
    """(B, S) prompts and (B, WHISPER_FRAMES, d) frames from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.normal(size=(B, WHISPER_FRAMES, cfg.d_model)).astype(
        np.float32)
    return toks, frames


def _whisper_serves(dev):
    """whisper-large-v3 at full width, 4 + 4 layers, fp and ``--mac
    int8`` (each from ``init_model`` in its mode: the same weights),
    weights drawn on the card: ``generate`` of 4 prompts with 1500 frames
    each, graphed and eager (identical), graphed again (identical), and
    one ``ServeEngine`` serve of the main trace without ``enc_x``, as the
    CLI serves it; kernels 1-3 never."""
    import torch
    from repro_torch.core.layers import MacConfig
    from repro_torch.models import init_model
    from repro_torch.serve import generate
    cfg = _whisper_cfg()
    toks, frames = _whisper_prompts(cfg)
    enc_x = torch.from_numpy(frames).to(dev)
    out = {}
    for mode in ("fp", "int8"):
        c = dataclasses.replace(cfg, mac=MacConfig(mode=mode))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_model(c, seed=0, device=dev, init_device=dev)
        res = {}
        for graphs in (True, False, True):
            torch.cuda.synchronize()
            _reset_counts()
            t1 = time.perf_counter()
            got = generate(params, c, toks, max_new=MAX_NEW,
                           extras={"enc_x": enc_x}, cuda_graphs=graphs)
            got = got.cpu().tolist()
            dt = time.perf_counter() - t1
            counts = _read_counts()
            what = f"{WHISPER_ARCH} {mode} {'graphed' if graphs else 'eager'}"
            assert counts["encoded_matmul"] == 0 and \
                counts["paged_attn"] == 0 and \
                counts["flash_attention"] == 0, f"kernels launched ({what})"
            assert len(got) == len(toks) and all(
                len(t) == MAX_NEW and all(0 <= x < cfg.vocab_size
                                          for x in t) for t in got), \
                f"{what}: not every row finished"
            key = "repeat" if ("graphed" in res and graphs) else \
                ("graphed" if graphs else "eager")
            res[key] = got
            log(f"[xw] {what} generate ({toks.shape[0]}, {toks.shape[1]}) "
                f"tokens + {WHISPER_FRAMES} frames, {MAX_NEW} new: "
                f"{toks.shape[0] * MAX_NEW / dt:.1f} tok/s, "
                f"{dt:.3f} s (prefill, encoder included)")
        for key in ("eager", "repeat"):
            if res[key] != res["graphed"]:
                raise AssertionError(f"{WHISPER_ARCH} {mode}: {key} "
                                     "generate differs from graphed")
        eng, stoks, dt, counts = _static(params, c, make_trace(c.vocab_size),
                                         dev)
        st = eng.stats()
        assert counts["encoded_matmul"] == 0 and counts["paged_attn"] == 0 \
            and counts["flash_attention"] == 0, \
            f"kernels launched ({WHISPER_ARCH} {mode} ServeEngine)"
        _finished(stoks, cfg, f"{WHISPER_ARCH} {mode} ServeEngine")
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"[xw] {WHISPER_ARCH} {mode}: graphed, eager and repeat "
            f"generate identical; ServeEngine without enc_x (zero cross "
            f"cache, as the CLI): {sum(map(len, stoks)) / dt:.1f} tok/s, "
            f"step p50 {st['step_ms_p50']:.2f} ms p99 "
            f"{st['step_ms_p99']:.2f} ms; peak device memory "
            f"{peak / 1e9:.2f} GB; part {time.perf_counter() - t0:.1f}s")
        out[mode] = {"peak_gb": peak / 1e9, "serve_tok_s":
                     sum(map(len, stoks)) / dt,
                     "step_ms_p50": st["step_ms_p50"]}
        del params, eng
    return out


def phase_xlstm_whisper(dev):
    """Phase 6j: xlstm-1.3b (8 of 48 blocks: 7 mLSTM, 1 sLSTM) through
    ``_serve_static_arch`` with the sLSTM block's share of a prefill, and
    whisper-large-v3 (4 + 4 layers) through ``_whisper_serves``."""
    out = {XLSTM_ARCH: _serve_static_arch(
        dev, XLSTM_ARCH, _xlstm_cfg(), "xw",
        extra=lambda p, c, trace: {"slstm": _slstm_share(dev, p, c,
                                                         trace)})}
    out[WHISPER_ARCH] = _whisper_serves(dev)
    return out


def _encoded_sites(params) -> dict:
    """{id(fp weight): (path, activation scale on the host)} of every
    folded linear of a param tree, sub-modules at any depth."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{k}")
            elif k + "_fw" in node:
                out[id(v)] = (f"{path}/{k}", node[k + "_as"].float().cpu())
    walk({k: v for k, v in params.items() if k != "layers"}, "")
    for li, layer in enumerate(params["layers"]):
        walk(layer, f"layer {li}")
    return out


def _card_cpu_origin(dev, trees, cfg, batch, max_new, extras, tag):
    """Where a static batch's greedy tokens first part between the CPU
    (plain versions) and the card (kernels): both run ``batch`` again
    eagerly through a ``StaticBatch`` (``extras`` into the prefill) while
    a hook reads every encoded linear's input over its activation scale,
    in forward order.  The first int8 code apart must sit within
    ``ORIGIN_TOL`` of a .5 boundary on both sides (f32 order moved it);
    raises otherwise, or if no code is apart."""
    import torch
    from repro_torch.nn.common import activation_recorder
    from repro_torch.serve.engine import StaticBatch
    calls = {}
    for where, params in trees.items():
        d = "cpu" if where == "cpu" else dev
        sites = _encoded_sites(params)
        rec = []

        def hook(name, w, x, sites=sites, rec=rec):
            if id(w) in sites:
                site, sa = sites[id(w)]
                rec.append((site, x.float().cpu() / sa))
        sb = StaticBatch(params, cfg, batch.shape[0],
                         batch.shape[1] + max_new + cfg.meta_tokens,
                         device=d, graphs=False)
        with torch.inference_mode(), activation_recorder(hook):
            sb.run(torch.from_numpy(batch), max_new, extras=extras)
        calls[where] = rec
        del sb
    before = 0.0
    for n, ((site, xc), (_, xg)) in enumerate(zip(calls["cpu"],
                                                  calls["cuda"])):
        qc, qg = (torch.clamp(torch.round(t), -127, 127) for t in (xc, xg))
        apart = (qc != qg).nonzero()
        if len(apart):
            idx = tuple(apart[0].tolist())
            u, v = xc[idx].item(), xg[idx].item()
            edge = max(abs(t - math.floor(t) - 0.5) for t in (u, v))
            log(f"[{tag}] card vs CPU: the first int8 code apart is at "
                f"linear call {n} ({site}, element {idx}): x / scale "
                f"{u:.7f} (CPU) against {v:.7f} (card), {edge:.1e} from the "
                f".5 boundary; every earlier input apart by up to "
                f"{before:.3e}")
            if edge > ORIGIN_TOL:
                raise AssertionError(f"{tag}: card and CPU part at an int8 "
                                     f"code {edge} from a .5 boundary")
            return edge
        before = max(before, (xc - xg).abs().max().item())
    raise AssertionError(f"{tag}: card and CPU tokens part with every int8 "
                         f"code equal (inputs apart by up to {before:.3e})")


def phase_cpu_parity_new(dev):
    """Phase 7 for the vlm and hybrid archs, reduced: the exact encoding
    folded on the CPU serves the main trace through ``ServeEngine`` on the
    card (kernels) and on the CPU (plain versions): identical greedy
    tokens, or, where a chunk's tokens part, a split that starts at an
    int8 code f32 order moved across a .5 boundary (``_card_cpu_origin``;
    hymba's reduced trace parts so at a layer-0 ``attn/wo`` input);
    phi-3-vision through ``generate``
    with an ``img`` made from the seed too; then 5 fp train steps of each
    from one torch-made state (phi-3-vision's batches with an ``img``):
    loss within ``CARD_CPU_RTOL`` at every step."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import init_model, to_device
    from repro_torch.serve import (arch_families, exact_encodings, generate,
                                   prepare_encoded_serving)
    from repro_torch.train import init_train_state, make_train_step
    for arch, _ in NEW_ARCHS:
        cfg = _new_cfg(arch, reduced=True)
        p_cpu = init_model(cfg, seed=0, device="cpu")
        cache = bundle_dir("parity-" + arch)
        pe_cpu, ce, _ = prepare_encoded_serving(
            p_cpu, cfg, device="cpu", cache_dir=cache, verbose=False,
            macs_override=exact_encodings(cfg.mac.bits, arch_families(cfg)))
        shutil.rmtree(cache)
        pe_gpu = to_device(pe_cpu, dev)
        trace = make_trace(cfg.vocab_size)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
        img = rng.normal(size=(2, cfg.n_patches, cfg.d_model)).astype(
            np.float32) if cfg.n_patches else None
        outs = {}
        for where, device, params in (("cpu", "cpu", pe_cpu),
                                      ("cuda", dev, pe_gpu)):
            seng, toks, _, counts = _static(params, ce, trace, device)
            if where == "cuda":
                _check_static_counts(counts, seng.chunks, ce,
                                     f"({arch} reduced, on the card)")
            outs[("static", where)] = toks
            if img is not None:
                outs[("generate with img", where)] = generate(
                    params, ce, prompts, max_new=8,
                    extras={"img": img}).cpu().tolist()
        trees = {"cpu": pe_cpu, "cuda": pe_gpu}
        for name in sorted({k[0] for k in outs}):
            a, b = outs[(name, "cpu")], outs[(name, "cuda")]
            n_same, parts = _agreement(a, b)
            log(f"[parity] {arch} reduced, {name}: greedy tokens card "
                f"(kernels) vs CPU (plain) {n_same} of {len(a)} identical, "
                f"parts (request, new token) {parts}")
            if name == "static":
                # each chunk that parts: the origin of its first split
                for c0 in sorted({i - i % N_SLOTS for i, _ in parts}):
                    chunk = trace[c0:c0 + N_SLOTS]
                    S = max(map(len, chunk))
                    batch = np.zeros((len(chunk), S), np.int32)
                    for r, q in enumerate(chunk):
                        batch[r, S - len(q):] = q
                    j = max(t for i, t in parts if c0 <= i < c0 + N_SLOTS)
                    _card_cpu_origin(dev, trees, ce, batch, j + 1, None,
                                     f"parity {arch} chunk {c0 // N_SLOTS}")
            elif parts:
                _card_cpu_origin(dev, trees, ce, prompts,
                                 max(t for _, t in parts) + 1,
                                 {"img": img}, f"parity {arch} {name}")
        s_cpu = init_train_state(cfg, seed=0, device="cpu")
        s_gpu = to_device(s_cpu, dev)
        step = make_train_step(cfg, warmup=TRAIN_WARMUP,
                               total_steps=TRAIN_STEPS)
        rds = SyntheticLMDataset(cfg.vocab_size, 32, seed=0)
        rows = []
        for i in range(5):
            b = rds.batch(i, 4)
            if img is not None:
                b["img"] = np.random.default_rng(10 + i).normal(
                    size=(4, cfg.n_patches, cfg.d_model)).astype(np.float32)
            s_cpu, mc = step(s_cpu, b)
            s_gpu, mg = step(s_gpu, b)
            rel = abs(float(mc["loss"]) - float(mg["loss"])) / max(
                abs(float(mc["loss"])), 1e-30)
            rows.append(f"{float(mc['loss']):.6f}/{float(mg['loss']):.6f}")
            if rel > CARD_CPU_RTOL:
                raise AssertionError(f"{arch} reduced fp train: card and CPU "
                                     f"part at step {i}: {rel}")
        log(f"[parity] {arch} reduced fp train: loss CPU/card within "
            f"{CARD_CPU_RTOL} at every step: {rows}")
    torch.cuda.empty_cache()


def _generate_tie(params, cfg, prompts, extras, a, b):
    """Where two greedy generations ``a`` and ``b`` of ``prompts`` first
    part (row, new token), the two candidates' logit margin over the
    largest |logit| from a no-cache forward of the prompt and ``a``'s
    tokens before it, on ``params``' device; None where they agree."""
    import numpy as np
    import torch
    from repro_torch.models import apply_model
    for i, (x, y) in enumerate(zip(a, b)):
        j = next((j for j, (u, v) in enumerate(zip(x, y)) if u != v), None)
        if j is None:
            continue
        dev = params["embed"]["table"].device
        toks = torch.from_numpy(np.concatenate(
            [prompts[i], np.asarray(x[:j], np.int32)])[None]).to(dev)
        kw = {k: torch.as_tensor(v[i:i + 1]).to(dev)
              for k, v in (extras or {}).items()}
        with torch.inference_mode():
            lg = apply_model(params, cfg, toks, **kw)[0][0, -1].float()
        return i, j, abs((lg[x[j]] - lg[y[j]]).item()) / \
            lg.abs().max().item()
    return None


def phase_cpu_parity_xw(dev):
    """Phase 7 for the xlstm and encdec archs, reduced: xlstm with one
    mLSTM and one sLSTM block, the exact encoding folded on the CPU,
    serves the main trace through ``ServeEngine`` on the card (kernel 1)
    and on the CPU (plain versions): identical greedy tokens, or a split
    whose first int8 code apart sits within ``ORIGIN_TOL`` of a .5
    boundary (``_card_cpu_origin``); whisper (fp) through ``generate``
    with ``enc_x`` from the seed: identical tokens, or a first split that
    is a near-tie within ``FP_TIE_RTOL`` of max|logit|; then 5 fp train
    steps of each from one torch-made state (whisper's batches with
    ``enc_x``): loss within ``CARD_CPU_RTOL`` at every step."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import init_model, to_device
    from repro_torch.serve import (arch_families, exact_encodings, generate,
                                   prepare_encoded_serving)
    from repro_torch.train import init_train_state, make_train_step
    cfg = _xlstm_cfg(reduced=True)
    p_cpu = init_model(cfg, seed=0, device="cpu")
    cache = bundle_dir("parity-xlstm")
    pe_cpu, ce, _ = prepare_encoded_serving(
        p_cpu, cfg, device="cpu", cache_dir=cache, verbose=False,
        macs_override=exact_encodings(cfg.mac.bits, arch_families(cfg)))
    shutil.rmtree(cache)
    pe_gpu = to_device(pe_cpu, dev)
    trace = make_trace(cfg.vocab_size)
    outs = {}
    for where, device, params in (("cpu", "cpu", pe_cpu),
                                  ("cuda", dev, pe_gpu)):
        seng, toks, _, counts = _static(params, ce, trace, device)
        if where == "cuda":
            _check_static_counts(counts, seng.chunks, ce,
                                 f"({XLSTM_ARCH} reduced, on the card)")
        outs[where] = toks
    n_same, parts = _agreement(outs["cpu"], outs["cuda"])
    log(f"[parity] {XLSTM_ARCH} reduced (mLSTM + sLSTM), static: greedy "
        f"tokens card (kernels) vs CPU (plain) {n_same} of {len(trace)} "
        f"identical, parts (request, new token) {parts}")
    trees = {"cpu": pe_cpu, "cuda": pe_gpu}
    for c0 in sorted({i - i % N_SLOTS for i, _ in parts}):
        chunk = trace[c0:c0 + N_SLOTS]
        S = max(map(len, chunk))
        batch = np.zeros((len(chunk), S), np.int32)
        for r, q in enumerate(chunk):
            batch[r, S - len(q):] = q
        j = max(t for i, t in parts if c0 <= i < c0 + N_SLOTS)
        _card_cpu_origin(dev, trees, ce, batch, j + 1, None,
                         f"parity {XLSTM_ARCH} chunk {c0 // N_SLOTS}")
    wcfg = _whisper_cfg(reduced=True)
    w_cpu = init_model(wcfg, seed=0, device="cpu")
    w_gpu = to_device(w_cpu, dev)
    prompts, frames = _whisper_prompts(wcfg, S=48)
    frames = frames[:, :48]
    got = {where: generate(p, wcfg, prompts, max_new=MAX_NEW,
                           extras={"enc_x": frames}).cpu().tolist()
           for where, p in (("cpu", w_cpu), ("cuda", w_gpu))}
    tie = _generate_tie(w_cpu, wcfg, prompts, {"enc_x": frames},
                        got["cpu"], got["cuda"])
    log(f"[parity] {WHISPER_ARCH} reduced, generate with enc_x (48 "
        f"frames): greedy tokens card vs CPU "
        f"{'identical' if tie is None else f'part at {tie[:2]}'}"
        + ("" if tie is None else f", a margin of {tie[2]:.2e} of "
           f"max|logit| (gated <= {FP_TIE_RTOL})"))
    if tie is not None and tie[2] > FP_TIE_RTOL:
        raise AssertionError(f"{WHISPER_ARCH} reduced: card and CPU part "
                             f"without a near-tie: {tie}")
    for arch, c in ((XLSTM_ARCH, cfg), (WHISPER_ARCH, wcfg)):
        s_cpu = init_train_state(c, seed=0, device="cpu")
        s_gpu = to_device(s_cpu, dev)
        step = make_train_step(c, warmup=TRAIN_WARMUP,
                               total_steps=TRAIN_STEPS)
        rds = SyntheticLMDataset(c.vocab_size, 32, seed=0)
        rows = []
        for i in range(5):
            b = rds.batch(i, 4)
            if c.family == "encdec":
                b["enc_x"] = np.random.default_rng(10 + i).normal(
                    size=(4, 8, c.d_model)).astype(np.float32)
            s_cpu, mc = step(s_cpu, b)
            s_gpu, mg = step(s_gpu, b)
            rel = abs(float(mc["loss"]) - float(mg["loss"])) / max(
                abs(float(mc["loss"])), 1e-30)
            rows.append(f"{float(mc['loss']):.6f}/{float(mg['loss']):.6f}")
            if rel > CARD_CPU_RTOL:
                raise AssertionError(f"{arch} reduced fp train: card and "
                                     f"CPU part at step {i}: {rel}")
        log(f"[parity] {arch} reduced fp train: loss CPU/card within "
            f"{CARD_CPU_RTOL} at every step: {rows}")
    torch.cuda.empty_cache()


def phase_cli_int8(dev):
    """``python -m repro_torch.launch.serve --reduced --mac int8`` on the
    card, in this process, on the static and the continuous engine (fused
    kernel 2): every request served, the int8 fake-quant executor named,
    kernel 1 never launched (int8 is plain PyTorch, as in the
    reference)."""
    import io
    from repro_torch.launch import serve as cli
    for extra in ([], ["--continuous", "--paged-attn", "kernel"]):
        argv = ["--reduced", "--mac", "int8", "--requests", "6",
                "--max-new", "8"] + extra
        buf = io.StringIO()
        _reset_counts()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        counts = _read_counts()
        text = buf.getvalue()
        served = [ln for ln in text.splitlines() if ln.startswith("served")]
        # the continuous engine counts decode tokens (6 x 7), as the
        # reference's CLI does
        ok = (len(served) == 1 and "served 6 requests, " +
              ("42" if extra else "48") + " tokens" in served[0]
              and "mac=int8" in served[0]
              and counts["encoded_matmul"] == 0
              and (counts["paged_attn"] > 0) == bool(extra))
        log(f"[cli] {' '.join(argv)}: {served} kernel 2 launches "
            f"{counts['paged_attn']}, kernel 1 {counts['encoded_matmul']} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"the serve CLI with --mac int8 {extra}: "
                                 f"{text[-2000:]}")


# the serve CLI's tensor-parallel run on the card (phase 7): reduced,
# exact encoding, the continuous engine with kernel 2
CLI_MESH_ARGV = ["--reduced", "--continuous", "--mac", "encoded",
                 "--encoding", "exact", "--paged-attn", "kernel",
                 "--requests", "4", "--max-new", "6"]


def _start(cmd, tmp, tag):
    """``cmd`` started with PYTHONPATH at this checkout's ``src``, its
    output into files under ``tmp``: (process, out path, err path,
    start time)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out, err = (os.path.join(tmp, f"{tag}.{k}") for k in ("out", "err"))
    with open(out, "w") as fo, open(err, "w") as fe:
        proc = subprocess.Popen(cmd, env=env, stdout=fo, stderr=fe, cwd=ROOT)
    return proc, out, err, time.perf_counter()


def _finish(started, timeout=600):
    """(exit code, stdout, stderr, seconds since start) of a ``_start``ed
    command, waited for."""
    proc, out, err, t0 = started
    try:
        code = proc.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(out) as fo, open(err) as fe:
        return code, fo.read(), fe.read(), time.perf_counter() - t0


def phase_cli_start(dev):
    """Phase 7's CLI runs in processes of their own, started here and
    joined by ``phase_cli_mesh``, ``phase_cli_train_mesh`` and
    ``phase_cli_train_full`` (the card phases between them run
    meanwhile; their gates compare tokens and losses, not times): the
    serve CLI with ``CLI_MESH_ARGV`` first in this process (it folds and
    writes the reduced bundle), then the same with ``--mesh 2``; the
    train CLI with ``CLI_TRAIN_ARGV --devices 2`` and, at full width,
    with ``CLI_TRAIN_FULL_ARGV``."""
    import io
    from repro_torch.launch import serve as cli
    tmp = bundle_dir("cli-ranks")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(CLI_MESH_ARGV)
    py = [sys.executable, "-m"]
    two, full = os.path.join(tmp, "two"), os.path.join(tmp, "full")
    return {"tmp": tmp, "alone": buf.getvalue(), "two": two, "full": full,
            "serve": _start(py + ["repro_torch.launch.serve"] + CLI_MESH_ARGV
                            + ["--mesh", "2"], tmp, "serve"),
            "train": _start(py + ["repro_torch.launch.train"]
                            + CLI_TRAIN_ARGV + ["--devices", "2",
                                                "--ckpt-dir", two],
                            tmp, "train"),
            "train_full": _start(py + ["repro_torch.launch.train"]
                                 + CLI_TRAIN_FULL_ARGV + ["--ckpt-dir", full],
                                 tmp, "train-full")}


def phase_cli_mesh(dev, started):
    """``python -m repro_torch.launch.serve`` with ``CLI_MESH_ARGV`` on the
    card, in this process (it folds and writes the reduced bundle), then
    the same command with ``--mesh 2`` as a user runs it (started by
    ``phase_cli_start``): the CLI spawns 2 ranks over gloo that share the
    card, each loads that bundle (a cache hit) and keeps its slices, and
    rank 0 prints the same tokens; ``--mesh 2x2`` exits 2 naming the
    data axis's ROADMAP item."""
    import io
    from repro_torch.launch import serve as cli
    alone = started["alone"]
    code, meshed, errs, dt = _finish(started["serve"])

    def toks(out):
        return [ln for ln in out.splitlines() if ln.startswith("req")]
    served = [ln.strip() for ln in meshed.splitlines()
              if ln.startswith("served") or "mesh:" in ln]
    log(f"[cli] {' '.join(CLI_MESH_ARGV)} --mesh 2: exit "
        f"{code} {dt:.1f}s after its start (2 ranks spawned by the CLI; "
        f"phase 7's card phases ran meanwhile); "
        f"{served}; tokens {toks(meshed)}, without --mesh {toks(alone)}")
    if code != 0:
        raise AssertionError(f"the serve CLI with --mesh 2 failed: "
                             f"{errs[-3000:]}")
    if not toks(alone) or toks(meshed) != toks(alone):
        raise AssertionError("the serve CLI with --mesh 2 printed other "
                             "tokens than without it")
    if ("cache hit" not in meshed or meshed.count("served 4 requests") != 1
            or "mesh: {'data': 1, 'model': 2}" not in meshed):
        raise AssertionError(f"the serve CLI with --mesh 2: {meshed[-2000:]}")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        try:
            cli.main(CLI_MESH_ARGV + ["--mesh", "2x2"])
        except SystemExit as e:
            code = e.code
        else:
            code = 0
    if code != 2 or "data axis" not in err.getvalue():
        raise AssertionError(f"--mesh 2x2: exit {code}, {err.getvalue()}")
    log(f"[cli] --mesh 2x2: exit 2, {err.getvalue().strip().splitlines()[-1]}")


# the train CLI on two ranks (phase 7): reduced, 4 steps, checkpoints at
# steps 2 and 4
CLI_TRAIN_ARGV = ["--reduced", "--steps", "4", "--batch", "4", "--seq",
                  "32", "--ckpt-every", "2"]


def _train_losses(out: str) -> dict:
    return {int(ln.split()[1]): float(ln.split()[3])
            for ln in out.splitlines() if ln.startswith("step ")}


def phase_cli_train_mesh(dev, started):
    """``python -m repro_torch.launch.train`` with ``CLI_TRAIN_ARGV`` on
    the card, in this process, and with ``--devices 2`` as a user runs it
    (started by ``phase_cli_start``; the CLI spawns 2 ranks over gloo that
    share the card; the reference's mesh choice, 1 x 2 at d_ff 256,
    printed): losses within 1e-3 of the one-rank run.  Then the 2 ranks'
    step-4 checkpoint removed and the one-rank command run again on their
    directory: it resumes from their step-2 checkpoint (the logical
    state) and its step 3 loss is theirs within 1e-3."""
    import io
    from repro_torch.launch import train as cli
    tmp, two = started["tmp"], started["two"]
    try:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(CLI_TRAIN_ARGV + ["--ckpt-dir", os.path.join(tmp, "one")])
        alone = buf.getvalue()
        code, meshed, errs, dt = _finish(started["train"])
        log(f"[cli] train {' '.join(CLI_TRAIN_ARGV)} --devices 2: exit "
            f"{code} {dt:.1f}s after its start (2 ranks spawned by the CLI; "
            "phase 7's card phases ran meanwhile): "
            + " | ".join(meshed.splitlines()) + "; without --devices: "
            + " | ".join(alone.splitlines()))
        if code != 0:
            raise AssertionError(f"the train CLI with --devices 2 failed: "
                                 f"{errs[-3000:]}")
        la, lm = _train_losses(alone), _train_losses(meshed)
        if ("mesh: {'data': 1, 'model': 2}" not in meshed or not la
                or sorted(la) != sorted(lm) or meshed.count("done") != 1
                or any(abs(la[k] - lm[k]) > MESH_LOSS_TOL for k in la)):
            raise AssertionError("the train CLI with --devices 2: its mesh "
                                 "or losses differ from one rank's")
        shutil.rmtree(os.path.join(two, "step_00000004"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(CLI_TRAIN_ARGV + ["--ckpt-dir", two])
        back = buf.getvalue()
        lb = _train_losses(back)
        log(f"[cli] the same on one rank over the 2 ranks' checkpoints: "
            + " | ".join(back.splitlines()))
        if ("resuming from step 2" not in back or 3 not in lb
                or abs(lb[3] - lm[3]) > MESH_LOSS_TOL):
            raise AssertionError("the one-rank CLI did not resume the 2 "
                                 "ranks' run at their step-3 loss")
    finally:
        shutil.rmtree(two, ignore_errors=True)


def phase_cpu_parity_moe(dev):
    """Phase 7 for the moe archs, reduced: the exact encoding folded on
    the CPU serves the main trace on the card (kernels) and on the CPU
    (plain versions), qwen3-moe through the continuous engine with dense,
    int8 and int4 pools, with the prefix cache (the shared-prefix trace)
    and with spec decoding (k = ``SPEC_K``, dense pools), and through
    ``ServeEngine``, deepseek-v3 through ``ServeEngine``: identical greedy
    tokens.  Then 5 fp train steps of
    each reduced config (router aux; deepseek-v3's MTP loss) on both
    devices from one torch-made state: loss and aux within
    ``CARD_CPU_RTOL`` at every step."""
    import torch
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import init_model, supports_paged_cache, to_device
    from repro_torch.serve import (arch_families, exact_encodings,
                                   prepare_encoded_serving)
    from repro_torch.train import init_train_state, make_train_step
    for arch, _, _ in MOE_ARCHS:
        cfg = _moe_cfg(arch, reduced=True)
        p_cpu = init_model(cfg, seed=0, device="cpu")
        cache = bundle_dir("parity-" + arch)
        pe_cpu, ce, _ = prepare_encoded_serving(
            p_cpu, cfg, device="cpu", cache_dir=cache, verbose=False,
            macs_override=exact_encodings(cfg.mac.bits, arch_families(cfg)))
        shutil.rmtree(cache)
        pe_gpu = to_device(pe_cpu, dev)
        trace = make_trace(cfg.vocab_size)
        outs = {}
        kvs = ("bf16", "int8", "int4") if supports_paged_cache(cfg) else ()
        for where, device, params in (("cpu", "cpu", pe_cpu),
                                      ("cuda", dev, pe_gpu)):
            for kv in kvs:
                ck = dataclasses.replace(ce, kv_cache_dtype=kv)
                eng, rids = _serve(params, ck, trace, device)
                _reset_counts()
                res = eng.run()
                counts = _read_counts()
                if where == "cuda":
                    _check_counts(counts, eng.stats(), ck, eng.prefill_chunk,
                                  f"({arch} reduced kv {kv}, on the card)")
                outs[(f"continuous kv {kv}", where)] = [
                    res[r].tolist() for r in rids]
            if kvs:
                # the prefix cache over the shared-prefix trace, and spec
                # decoding (self drafter) over the main trace
                for name, tr, kw in (
                        ("prefix cache", _prefix_trace(ce.vocab_size),
                         dict(prefix_cache=True)),
                        (f"spec k={SPEC_K}", trace,
                         dict(spec_decode=SPEC_K))):
                    eng, rids = _serve(params, ce, tr, device, **kw)
                    _reset_counts()
                    res = eng.run()
                    counts = _read_counts()
                    if where == "cuda":
                        _check_counts(counts, eng.stats(), ce,
                                      eng.prefill_chunk,
                                      f"({arch} reduced {name}, on the card)")
                    outs[(name, where)] = [res[r].tolist() for r in rids]
            seng, toks, _, counts = _static(params, ce, trace, device)
            if where == "cuda":
                _check_static_counts(counts, seng.chunks, ce,
                                     f"({arch} reduced, on the card)")
            outs[("static", where)] = toks
        for name in sorted({k[0] for k in outs}):
            same = outs[(name, "cpu")] == outs[(name, "cuda")]
            log(f"[parity] {arch} reduced, {name}: greedy tokens card "
                f"(kernels) vs CPU (plain) {'identical' if same else 'DIFFERENT'}"
                f" ({sum(map(len, outs[(name, 'cpu')]))} tokens)")
            if not same:
                raise AssertionError(f"{arch} reduced {name}: card and CPU "
                                     "greedy tokens differ")
        s_cpu = init_train_state(cfg, seed=0, device="cpu")
        s_gpu = to_device(s_cpu, dev)
        step = make_train_step(cfg, warmup=TRAIN_WARMUP,
                               total_steps=TRAIN_STEPS)
        rds = SyntheticLMDataset(cfg.vocab_size, 32, seed=0)
        rows = []
        for i in range(5):
            b = rds.batch(i, 4)
            s_cpu, mc = step(s_cpu, b)
            s_gpu, mg = step(s_gpu, b)
            rel = {k: abs(float(mc[k]) - float(mg[k])) / max(
                abs(float(mc[k])), 1e-30) for k in ("loss", "aux")}
            rows.append(f"{float(mc['loss']):.6f}/{float(mg['loss']):.6f} "
                        f"aux {float(mc['aux']):.6f}/{float(mg['aux']):.6f}")
            if max(rel.values()) > CARD_CPU_RTOL:
                raise AssertionError(f"{arch} reduced fp train: card and CPU "
                                     f"part at step {i}: {rel}")
        log(f"[parity] {arch} reduced fp train (mtp {cfg.mtp}, router "
            f"{cfg.router_type}): loss and aux CPU/card within "
            f"{CARD_CPU_RTOL} at every step: {rows}")
    torch.cuda.empty_cache()


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

def phase_cpu_parity_archs(dev):
    """Phase 7 for the other dense archs: each reduced config, exact
    encoding folded on the CPU, serves the main trace on the card
    (kernels) and on the CPU (plain versions) through the continuous
    engine and ``ServeEngine``: identical greedy tokens."""
    import torch
    from repro_torch.models import init_model, to_device
    from repro_torch.serve import exact_encodings, prepare_encoded_serving
    for arch, _ in ARCH_DEPTHS:
        cfg = _arch_cfg(arch).reduced()
        p_cpu = init_model(cfg, seed=0, device="cpu")
        cache = bundle_dir("parity-" + arch)
        pe_cpu, ce, _ = prepare_encoded_serving(
            p_cpu, cfg, macs_override=exact_encodings(cfg.mac.bits),
            device="cpu", cache_dir=cache, verbose=False)
        shutil.rmtree(cache)
        pe_gpu = to_device(pe_cpu, dev)
        trace = make_trace(cfg.vocab_size)
        outs = {}
        for where, device, params in (("cpu", "cpu", pe_cpu),
                                      ("cuda", dev, pe_gpu)):
            eng, rids = _serve(params, ce, trace, device)
            _reset_counts()
            res = eng.run()
            counts = _read_counts()
            if where == "cuda":
                _check_counts(counts, eng.stats(), ce, eng.prefill_chunk,
                              f"({arch} reduced, on the card)")
            outs[("continuous", where)] = [res[r].tolist() for r in rids]
            seng, toks, _, counts = _static(params, ce, trace, device)
            if where == "cuda":
                _check_static_counts(counts, seng.chunks, ce,
                                     f"({arch} reduced, on the card)")
            outs[("static", where)] = toks
        for name in ("continuous", "static"):
            same = outs[(name, "cpu")] == outs[(name, "cuda")]
            log(f"[parity] {arch} reduced, {name}: greedy tokens card "
                f"(kernels) vs CPU (plain) {'identical' if same else 'DIFFERENT'}"
                f" ({sum(map(len, outs[(name, 'cpu')]))} tokens)")
            if not same:
                raise AssertionError(f"{arch} reduced {name}: card and CPU "
                                     "greedy tokens differ")
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
    fw = _fw_bytes(params_enc)
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


# --- phase 9: the trainer -------------------------------------------------

# full-width qwen1.5-0.5b trained in each MAC mode: batch x seq tokens per
# step (m = 2048 rows per linear), steps per mode, warm-up of the schedule
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP = 8, 256, 10, 2
# steps of the run whose loss is recorded, not gated (the searched
# encoding): its first steps of the same schedule
TRAIN_UNGATED_STEPS = 4
# steps of the int8 and exact-encoded runs (the same forward: the exact
# run's step 0 is gated equal to int8's); each loss must fall over them
# (the card runs of PRs 19-24: step 3 below step 0 in both)
TRAIN_QUANT_STEPS = 4
# predicted in PERF.md before the first card run (logged beside the
# outcome, not gated): the last loss below the first by at least this
TRAIN_MARGIN = 0.05
# card against CPU at reduced size: fp losses, and step 0 of the quantized
# modes (loss and the first moments, which hold the clipped gradient)
CARD_CPU_RTOL = 1e-4
# where card and CPU part in a quantized mode, the first int8 code apart
# must come from f32 order: its two values before rounding within this of
# each other, relative (the searched encoding's f32 fold sums terms that
# cancel, so a linear's output parts by up to ~1e-4 between orders; the
# first card run found layer 0's attn/wo input at -83.4962 on the CPU and
# -83.5002 on the card, 4.8e-5 apart)
TRAIN_ORIGIN_RTOL = 1e-4


def _train_cfg(mode, mac, reduced=False):
    """qwen1.5-0.5b (full or reduced) in MAC ``mode`` with encoding
    ``mac`` (used by 'encoded' only)."""
    from repro_torch.configs import get_config
    from repro_torch.core.layers import MacConfig
    cfg = get_config("qwen1.5-0.5b")
    if reduced:
        cfg = cfg.reduced()
    if mode != "fp":
        cfg = dataclasses.replace(cfg, mac=MacConfig(
            mode=mode, mac=mac if mode == "encoded" else None))
    return cfg


def _train_run(cfg, dev, batches, steps, state=None, **kw):
    """``steps`` train steps from seed 0's state (or ``state``): the final
    state, per-step losses, gnorms and host-clock ms (each step ends in a
    sync), and the peak device memory."""
    import torch
    from repro_torch.train import init_train_state, make_train_step
    if state is None:
        state = init_train_state(cfg, seed=0, device=dev)
    step = make_train_step(cfg, warmup=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, ms = [], [], []
    for i in range(steps):
        t = time.perf_counter()
        state, m = step(state, batches[i])
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return state, losses, gnorms, ms, torch.cuda.max_memory_allocated()


def _p50(xs):
    import numpy as np
    return float(np.median(xs))


def _fold_share(step_fn):
    """Share of the device time of one call of ``step_fn`` spent in
    kernels launched inside the ``qat_fold`` ranges (the encoded QAT
    forward's quantize + fold + bitplane product; under remat it runs in
    the forward and again in the backward's recompute; the backward's own
    kernels fall outside), from a ``torch.profiler`` chrome trace."""
    import bisect
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(ROOT, "build", f"train-trace-{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
        kernels = [e for e in events if e.get("cat") == "kernel"]
        if kernels:
            break
    if not kernels:
        return None
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    ranges = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") == "qat_fold")
    starts = [r[0] for r in ranges]
    total = fold = 0.0
    for k in kernels:
        dur = float(k.get("dur", 0.0))
        total += dur
        ts = launch.get(k.get("args", {}).get("correlation"))
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        if i >= 0 and ranges[i][0] <= ts <= ranges[i][1]:
            fold += dur
    return {"fold_ms": fold / 1e3, "device_ms": total / 1e3,
            "share": fold / total if total else float("nan"),
            "ranges": len(ranges)}


def _leaf_rel(a, b, prefix=""):
    """(path, max|a - b| / max|a|) for each leaf of two trees of tensors
    (b may live on the card)."""
    for k in sorted(a):
        if isinstance(a[k], dict):
            yield from _leaf_rel(a[k], b[k], f"{prefix}{k}/")
        else:
            x, y = a[k].float(), b[k].float().cpu()
            yield (prefix + k, ((x - y).abs().max()
                                / x.abs().max().clamp_min(1e-30)).item())


def _linear_inputs(dev, cfg, state, tokens, mesh=None):
    """Every linear's input over its activation scale, in forward order,
    from ``state``'s params on ``dev`` (under ``mesh``: this rank's, a row
    linear's input gathered over the model axis), on the host as (site,
    tensor): what ``_first_flip`` compares."""
    import torch
    from repro_torch.models import apply_model, to_device
    from repro_torch.nn.common import activation_recorder
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.train import params_of
    calls = ("wq", "wk", "wv", "wo", "wi", "wg", "wo")
    sub = ("attn",) * 4 + ("mlp",) * 3
    xs = []

    def hook(name, w, x):
        if mesh is not None and name == "wo":
            x = mesh.gather_columns(x.contiguous())
        xs.append(x.float().cpu())
    with torch.no_grad(), set_mesh(mesh), activation_recorder(hook):
        apply_model(to_device(params_of(state), dev), cfg,
                    torch.as_tensor(tokens).to(dev))
    stack = state["params"]["stack"]
    return [(f"layer {c // 7} {sub[c % 7]}/{calls[c % 7]}",
             x / stack[sub[c % 7]][calls[c % 7] + "_as"][c // 7].item())
            for c, x in enumerate(xs)]


def _first_flip(a, b):
    """The first linear input of two recorded forwards (``_linear_inputs``)
    whose int8 codes differ: (site, its first such value in ``a``, in
    ``b``, the codes apart at that site), or None."""
    import torch
    for (site, x), (_, y) in zip(a, b):
        cx = torch.clamp(torch.round(x), -127, 127)
        cy = torch.clamp(torch.round(y), -127, 127)
        diff = (cx != cy).reshape(-1).nonzero()
        if len(diff):
            i = int(diff[0])
            return (site, x.reshape(-1)[i].item(), y.reshape(-1)[i].item(),
                    len(diff))
    return None


def phase_train(dev):
    """Phase 9: the trainer on full-width qwen1.5-0.5b (see the module
    docstring)."""
    from repro_torch.core.mac import EncodedMac
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.serve import exact_encodings
    t_phase = time.perf_counter()
    t = time.perf_counter()
    mac = EncodedMac.default(device=dev)
    log(f"[train] EncodedMac.default() in {time.perf_counter() - t:.1f}s: "
        f"U = {mac.program.n_a_planes} activation planes, V = "
        f"{mac.program.n_b_planes} weight planes, rmse {mac.spec.rmse:.4g}")
    exact = exact_encodings()["wq"]
    ds = SyntheticLMDataset(_train_cfg("fp", None).vocab_size, TRAIN_S,
                            seed=0)
    batches = [ds.batch(i, TRAIN_B) for i in range(TRAIN_STEPS)]
    info = _train_modes(dev, mac, exact, batches)
    _train_remat_off(dev, batches, info)
    _train_microbatch(dev, batches)
    _train_resume(dev, mac, batches)
    _train_card_cpu(dev, mac, exact)
    log(f"[train] phase 9 in {time.perf_counter() - t_phase:.1f}s")
    return info


def _train_modes(dev, mac, exact, batches):
    """10 steps in each MAC mode at full width: gates, times, memory."""
    import torch
    from repro_torch.train import make_train_step
    tok = TRAIN_B * TRAIN_S
    info = {}
    # (tag, MAC mode, encoding, the last loss must fall below the first):
    # the searched default encoding's loss rises at this width in the
    # reference too (ROADMAP Queue C), so it is recorded, not gated; the
    # exact encoding computes int8 fake quant's forward bit for bit, so its
    # first loss must equal the int8 run's and it must fall
    runs = (("fp", "fp", None, True, TRAIN_STEPS),
            ("int8", "int8", None, True, TRAIN_QUANT_STEPS),
            ("encoded", "encoded", mac, False, TRAIN_UNGATED_STEPS),
            ("encoded-exact", "encoded", exact, True, TRAIN_QUANT_STEPS))
    for tag, mode, enc, gate, n in runs:
        cfg = _train_cfg(mode, enc)
        _reset_counts()
        st, losses, gnorms, ms, peak = _train_run(cfg, dev, batches, n)
        counts = _read_counts()
        busy = {k: v for k, v in counts.items() if v}
        if busy:
            raise AssertionError(f"training ({tag}) launched kernels 1-3: "
                                 f"{busy}")
        if not all(map(math.isfinite, losses + gnorms)):
            raise AssertionError(f"{tag}: non-finite loss or gnorm: "
                                 f"{losses} {gnorms}")
        drop = losses[0] - losses[-1]
        p50 = _p50(ms[1:])
        info[tag] = dict(p50=p50, peak=peak, drop=drop, losses=losses)
        log(f"[train] {tag}: {n} steps of {TRAIN_B}x{TRAIN_S}"
            f"{'' if enc is None else f', U = {enc.program.n_a_planes}'}, "
            f"losses {[round(x, 4) for x in losses]}, gnorms "
            f"{[round(x, 3) for x in gnorms]}; first step {ms[0]:.1f} ms, "
            f"step p50 {p50:.1f} ms (steps 1-{n - 1}), "
            f"{tok / p50 * 1e3:.0f} tokens/s, peak device memory "
            f"{peak / 1e9:.2f} GB, remat on; kernels 1-3 launches 0 "
            f"({SMI})")
        log(f"[train] {tag}: loss fell by {drop:.4f} over {n} "
            f"steps (predicted: at least {TRAIN_MARGIN}; "
            f"{'gated: must fall' if gate else 'not gated'})")
        if gate and not losses[-1] < losses[0]:
            raise AssertionError(f"{tag}: the last loss {losses[-1]} is not "
                                 f"below the first {losses[0]}")
        if tag == "encoded-exact":
            rel = abs(losses[0] - info["int8"]["losses"][0]) / losses[0]
            log(f"[train] encoded-exact step 0 loss against int8's: rel "
                f"{rel:.2e} (the same forward; gated at {CARD_CPU_RTOL})")
            if rel > CARD_CPU_RTOL:
                raise AssertionError("the exact encoding's first loss is not "
                                     "int8 fake quant's")
        if tag == "encoded":
            step = make_train_step(cfg, warmup=TRAIN_WARMUP,
                                   total_steps=TRAIN_STEPS)
            share = _fold_share(lambda: step(st, batches[0]))
            if share is None:
                log("[train] encoded: the profiler recorded no device "
                    "kernels; the fold's share is not measured")
            else:
                log(f"[train] encoded: QAT fold forward (quantize + fold + "
                    f"bitplane product, {share['ranges']} ranges: 168 "
                    f"linears, twice under remat) {share['fold_ms']:.1f} ms "
                    f"of {share['device_ms']:.1f} ms device time in one "
                    f"step = {share['share']:.3f} (torch.profiler; the "
                    f"backward's kernels not counted in the fold)")
            info[tag]["fold"] = share
        del st
        torch.cuda.empty_cache()
    return info


def _train_remat_off(dev, batches, info):
    import torch
    tok = TRAIN_B * TRAIN_S
    # remat off, fp (remat on above): fewer recomputed forwards, more
    # memory held from the forward to the backward
    cfg = dataclasses.replace(_train_cfg("fp", None), remat=False)
    st, losses, _, ms, peak = _train_run(cfg, dev, batches, 4)
    log(f"[train] fp, remat off: step p50 {_p50(ms[1:]):.1f} ms (steps 1-3)"
        f", {tok / _p50(ms[1:]) * 1e3:.0f} tokens/s, peak device memory "
        f"{peak / 1e9:.2f} GB; remat on: {info['fp']['p50']:.1f} ms, "
        f"{info['fp']['peak'] / 1e9:.2f} GB ({SMI})")
    del st
    torch.cuda.empty_cache()



def _train_microbatch(dev, batches):
    import torch
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    # microbatching: microbatch=2 (4 chunks) from the same state gives the
    # full batch's params within the reference's tolerance
    cfg = _train_cfg("fp", None)
    s0 = init_train_state(cfg, seed=0, device=dev)
    full, mf = make_train_step(cfg)(s0, batches[0])
    mb, mm_ = make_train_step(cfg, microbatch=2)(s0, batches[0])
    worst = 0.0
    for a, c in zip(tree_leaves(full["params"]), tree_leaves(mb["params"])):
        excess = ((a - c).abs() - 5e-5 - 5e-4 * a.abs()).max().item()
        worst = max(worst, excess)
    log(f"[train] microbatch=2 against the full batch (fp): max "
        f"|diff| - (5e-5 + 5e-4|ref|) = {worst:.3e} (<= 0 passes); loss "
        f"{float(mf['loss']):.6f} full, {float(mm_['loss']):.6f} last "
        f"chunk")
    if worst > 0:
        raise AssertionError("microbatch=2 params differ from the full "
                             "batch's beyond rtol 5e-4 / atol 5e-5")
    del s0, full, mb
    torch.cuda.empty_cache()



def _train_resume(dev, mac, batches):
    import warnings
    import torch
    from repro_torch.ckpt import async_save_checkpoint, restore_checkpoint
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    # checkpoint and resume, encoded: 3 steps straight, against 2 steps,
    # an async save, a restore into a fresh state and the third step;
    # deterministic algorithms so the two third steps match bit for bit
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    cfg = _train_cfg("encoded", mac)
    ck = bundle_dir("train-ckpt")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step = make_train_step(cfg, warmup=TRAIN_WARMUP,
                                   total_steps=TRAIN_STEPS)
            st = init_train_state(cfg, seed=0, device=dev)
            for i in range(2):
                st, _ = step(st, batches[i])
            t = time.perf_counter()
            th = async_save_checkpoint(ck, 2, st)
            snap_s = time.perf_counter() - t
            straight, m_a = step(st, batches[2])
            th.join()
            write_s = time.perf_counter() - t
            del st
            fresh = init_train_state(cfg, seed=1, device=dev)
            t = time.perf_counter()
            back = restore_checkpoint(ck, 2, fresh)
            read_s = time.perf_counter() - t
            del fresh
            resumed, m_b = step(back, batches[2])
            torch.cuda.synchronize()
        nondet = sorted({str(w.message).split(" does not have")[0]
                         for w in caught
                         if "deterministic" in str(w.message)})
        size = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(ck) for f in fs)
        diff = max((a.float() - c.float()).abs().max().item()
                   for a, c in zip(tree_leaves(straight),
                                   tree_leaves(resumed)))
        log(f"[train] resume (encoded): checkpoint {size / 1e9:.2f} GB, "
            f"host snapshot {snap_s:.1f}s, written by {write_s:.1f}s "
            f"(overlapping step 3), restored in {read_s:.1f}s; step 3 loss "
            f"{float(m_a['loss']):.6f} straight, {float(m_b['loss']):.6f} "
            f"resumed; max |state diff| {diff:.3e}; ops without a "
            f"deterministic CUDA path: {nondet or 'none'}")
        if nondet:
            worst = max(((a.float() - c.float()).abs() - 5e-5
                         - 5e-4 * a.float().abs()).max().item()
                        for a, c in zip(tree_leaves(straight),
                                        tree_leaves(resumed)))
            if worst > 0:
                raise AssertionError("resumed state beyond rtol 5e-4 / "
                                     "atol 5e-5 of the straight run")
        elif diff != 0.0 or float(m_a["loss"]) != float(m_b["loss"]):
            raise AssertionError("resume is not bit for bit under "
                                 "deterministic algorithms")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ck, ignore_errors=True)
    del straight, resumed, back
    torch.cuda.empty_cache()



def _train_card_cpu(dev, mac, exact):
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import to_device
    from repro_torch.train import init_train_state, make_train_step
    # card against CPU at reduced size: the same torch-made state, 5 steps.
    # fp is held at every step; a quantized mode at step 0 (loss and first
    # moments, or a parting that starts at an int8 code f32 order moved
    # across a .5 boundary); later steps are printed, and where they part
    # the first code apart and the params furthest apart are logged
    for tag, mode, enc in (("fp", "fp", None), ("int8", "int8", None),
                           ("encoded", "encoded", mac),
                           ("encoded-exact", "encoded", exact)):
        cfg = _train_cfg(mode, enc, reduced=True)
        rds = SyntheticLMDataset(cfg.vocab_size, 32, seed=0)
        rb = [rds.batch(i, 4) for i in range(5)]
        s_cpu = init_train_state(cfg, seed=0, device="cpu")
        s_gpu = to_device(s_cpu, dev)
        step = make_train_step(cfg, warmup=TRAIN_WARMUP,
                               total_steps=TRAIN_STEPS)
        rows, parted, befores = [], None, []
        for i in range(5):
            befores.append((s_cpu, s_gpu))
            s_cpu, mc = step(s_cpu, rb[i])
            s_gpu, mg = step(s_gpu, rb[i])
            rel = abs(float(mc["loss"]) - float(mg["loss"])) / abs(
                float(mc["loss"]))
            rows.append(f"{float(mc['loss']):.6f}/{float(mg['loss']):.6f}")
            if parted is not None:
                continue
            worst = ("", 0.0)
            if i == 0:
                # the first moments after step 0 are 0.1 x the clipped
                # gradient
                worst = max(_leaf_rel(s_cpu["opt"]["m"], s_gpu["opt"]["m"]),
                            key=lambda t: t[1])
                log(f"[train] card vs CPU, reduced {tag}, step 0: loss rel "
                    f"{rel:.2e}, first moments (0.1 x clipped gradient) "
                    f"worst leaf {worst[0]} rel {worst[1]:.2e}")
            if rel <= CARD_CPU_RTOL and worst[1] <= CARD_CPU_RTOL:
                continue
            if mode == "fp":
                raise AssertionError(f"fp: card and CPU part at step {i}: "
                                     f"loss rel {rel:.2e}, {worst}")
            # the earliest step whose forward, run on both devices from the
            # CPU's (or else the card's) state before it, moves an int8 code
            # (a moved code need not part the loss at once, so it may
            # precede step i)
            flip = next(((j, f) for j in range(i + 1) for st in befores[j]
                         for f in [_first_flip(
                             _linear_inputs("cpu", cfg, st, rb[j]["tokens"]),
                             _linear_inputs(dev, cfg, st, rb[j]["tokens"]))]
                         if f is not None), None)
            moved = flip is not None and abs(flip[1][1] - flip[1][2]) <= \
                TRAIN_ORIGIN_RTOL * max(abs(flip[1][1]), 1.0)
            apart = max(_leaf_rel(befores[i][0]["params"],
                                  befores[i][1]["params"]),
                        key=lambda t: t[1])
            log(f"[train] card vs CPU, reduced {tag}: part at step {i} (loss "
                f"rel {rel:.2e}); first int8 code apart (step, (site, CPU, "
                f"card, codes apart)): {flip}; params before step {i} "
                f"furthest apart: {apart[0]} rel {apart[1]:.2e}")
            # step 0 starts from one state: there a parting must come from
            # a code f32 order moved across a .5 boundary; later steps are
            # reported, not gated (the two devices train their own states)
            if i == 0 and not moved:
                raise AssertionError(
                    f"{tag}: card and CPU part at step 0 (loss rel "
                    f"{rel:.2e}, {worst}) without an int8 code that f32 "
                    f"order moved across a .5 boundary: {flip}")
            parted = (i, flip)
        log(f"[train] card vs CPU, reduced {tag}: losses CPU/card {rows}"
            + ("" if parted is None else f" (part at step {parted[0]})"))



# the train CLI at full width (phase 7): encoded, 2 steps and a
# checkpoint at step 2 (its resume is held in-process at full width by
# ``_train_resume`` and through the CLI at reduced size by
# ``phase_cli_train_mesh``)
CLI_TRAIN_FULL_ARGV = ["--steps", "2", "--batch", "4", "--seq", "128",
                       "--mac-mode", "encoded", "--ckpt-every", "2"]


def phase_cli_train_full(dev, started):
    """``python -m repro_torch.launch.train`` with ``CLI_TRAIN_FULL_ARGV``
    on the card (full-width qwen1.5-0.5b; started by ``phase_cli_start``):
    exit 0, both steps printed, the step-2 checkpoint committed."""
    code, out, errs, dt = _finish(started["train_full"])
    lines = [ln for ln in out.splitlines() if ln.strip()]
    log(f"[train] CLI (full width) {' '.join(CLI_TRAIN_FULL_ARGV)}: exit "
        f"{code} {dt:.1f}s after its start (phase 7's card phases ran "
        "meanwhile): " + " | ".join(lines))
    if code != 0:
        raise AssertionError(f"train CLI failed: {errs[-2000:]}")
    committed = sorted(os.listdir(started["full"]))
    if committed != ["step_00000002"] or not any(
            ln.startswith("step 1 ") for ln in lines):
        raise AssertionError(f"CLI checkpoints {committed}, {lines}")


def _time_once(fn, args) -> float:
    """ms of one call of ``fn`` on the card (CUDA events)."""
    import torch
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    fn(*args)
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


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
    torch.cuda.empty_cache()
    out, ref = em.encoded_matmul(*sets[0]), em.encoded_matmul_plain(*sets[0])
    err = (out - ref).abs().max().item()
    if not torch.allclose(out, ref, rtol=1e-4,
                          atol=1e-4 * ref.abs().max().item()):
        raise AssertionError(f"{name}: kernel 1 disagrees with plain "
                             f"(max abs err {err:.3e})")
    del out, ref
    ms = time_graph(em.encoded_matmul, sets, iters=40)
    plain_ms = time_loop(em.encoded_matmul_plain, sets)
    lib_sets = [(planes_ref(x, sh).to(torch.bfloat16).permute(1, 0, 2)
                 .reshape(m, U * k).contiguous(), wt.reshape(U * k, n))
                for x, wt, _, sh in sets]
    lib_ms = time_graph(lib[0], lib_sets, iters=40)
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


def _pa_row(dev, mode, sq, Hq, Hkv, D, P, lens, window, cap, name, note,
            launches, seed):
    """Kernel 2's row of the kernels line: 4 rows of ``lens`` at Sq
    ``sq``, ``mode`` pools ('bf16' = dense f32), kernel and plain version
    timed over 8 input sets, beside the launch floor (an empty kernel on
    the same grid and cluster, replayed the same way)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.kernel_bench import time_graph
    B, ps = N_SLOTS, PAGE_SIZE
    if mode == "bf16":
        sets, kv_map = _pa_case(dev, B, sq, Hq, Hkv, D, ps, P, lens,
                                torch.float32, seed=seed, copies=8)
        args = [a + (None, None) for a in sets]
    else:
        qsets, kv_map = _pa_quant_case(dev, mode, B, sq, Hq, Hkv, D, ps, P,
                                       lens, seed=seed, copies=8)
        args = [a + sc for a, sc in qsets]
    G = Hq // Hkv

    def kern(q, pk, pv, pg, ln, sk, sv):
        return pa.paged_attn(q, pk, pv, pg, ln, scale=D ** -0.5,
                             window=window, cap=cap, kv_of_q=kv_map,
                             scale_k=sk, scale_v=sv)

    def plain(q, pk, pv, pg, ln, sk, sv):
        return pa.paged_attn_plain(q, pk, pv, pg, ln,
                                   window or pa._NO_WINDOW, scale=D ** -0.5,
                                   cap=cap, G=G, scale_k=sk, scale_v=sv)

    err = (kern(*args[0]) - plain(*args[0])).abs().max().item()
    ms = time_graph(kern, args)
    plain_ms = time_loop(plain, args)
    floor_ms = time_graph(lambda: pa.paged_attn_floor(B, Hkv, P, dev),
                          [()] * 8)
    read = sum((l_ + sq - 1) // ps + 1 for l_ in lens)  # pages per kv head
    row_bytes = D * 4 if mode == "bf16" else (
        D // 2 + 4 if mode == "int4" else D + 4)
    nbytes = (2 * B * sq * Hq * D * 4 + 2 * read * ps * Hkv * row_bytes
              + read * 4 + B * 4)
    ops = 4.0 * sq * D * read * ps * Hq
    t_b, t_o = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return {
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
        "cluster": pa.cluster_size(B, Hkv, P, torch.cuda.get_device_properties(
            dev).multi_processor_count),
        "shape": f"B={B} Sq={sq} Hq={Hq} Hkv={Hkv} D={D} ps={ps} P={P} "
                 f"lens={lens} window={window} cap={cap} {note}, "
                 f"{nbytes / 1e6:.3f} MB"}


def phase_measure(dev, serve_info):
    """Kernel, plain and library times at the main path's shapes."""
    import torch
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
    static_shape = serve_info["static"]["counts"]["encoded_matmul_by_shape"]
    for m in (N_SLOTS, 32):
        for k, n in shapes:
            rows.append(_em_row(
                dev, prog, m, k, n, 1, f"encoded_matmul_m{m}_k{k}_n{n}",
                by_shape.get((m, k, n), 0),
                "decode" if m == N_SLOTS else "prefill", lib))
    for r in rows:                     # the static serve decodes at m = 4
        m, k, n = (int(t[1:]) for t in r["name"].split("_")[-3:])
        r["launches_static"] = static_shape.get((m, k, n), 0)
    # kernel 1 at the static engine's prefills of the main trace (m =
    # batch x the chunk's longest prompt); launches: the static serve's
    for m in static_prefill_ms():
        for k, n in shapes:
            rows.append(_em_row(
                dev, prog, m, k, n, 5,
                f"encoded_matmul_static_m{m}_k{k}_n{n}",
                static_shape.get((m, k, n), 0),
                "static prefill; launches: the static serve", lib))
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
    lens = [100, 200, 300, 400]
    cases = [(mode, P, 1) for mode in ("bf16", "int8", "int4")
             for P in (32, SERVE_P)]
    cases += [("bf16", SERVE_P, SPEC_K + 1), ("bf16", SERVE_P, 9)]
    for mode, P, sq in cases:
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
        rows.append(_pa_row(dev, mode, sq, 16, 16, 64, P, lens, None, None,
                            name, note, launches,
                            seed=(5 if sq == 1 else 7) if mode == "bf16"
                            else 6))
    # kernel 2 at head dim 128 with the other dense archs' head layouts,
    # f32 pools and the serve's table (gemma2 with its layer-0 window and
    # softcap); launches: the arch's continuous serve (phase 6f)
    for arch, _ in ARCH_DEPTHS:
        cfg = serve_info["archs"][arch]["cfg"]
        rows.append(_pa_row(
            dev, "bf16", 1, cfg.n_heads_p, cfg.n_kv_p, cfg.head_dim_r,
            SERVE_P, lens, cfg.layer_windows[0], cfg.attn_softcap,
            f"paged_attn_{arch}_p{SERVE_P}", f"f32 pools, {arch} heads",
            serve_info["archs"][arch]["counts"]["paged_attn"], seed=8))
    # kernel 2 at qwen3-moe's 64/4 heads (group 16), D 128, f32 / int8 /
    # int4 pools and the serve's table; launches: its continuous serves
    # with each pool type (phase 6h)
    qcfg = serve_info["moe"]["qwen3-moe-235b-a22b"]["cfg"]
    for mode in ("bf16", "int8", "int4"):
        rows.append(_pa_row(
            dev, mode, 1, qcfg.n_heads_p, qcfg.n_kv_p, qcfg.head_dim_r,
            SERVE_P, lens, None, None,
            f"paged_attn_qwen3-moe{'' if mode == 'bf16' else '_' + mode}"
            f"_p{SERVE_P}",
            "f32 pools" if mode == "bf16" else f"{mode} pools + f32 scales",
            serve_info["moe"]["qwen3-moe-235b-a22b"]["paged"][mode],
            seed=9))
    # kernel 2 at qwen3-moe's verify forwards (Sq = 5 and 9: 80 and 144
    # rows a kv head, D 128; f32 pools take them in two chunks), each pool
    # type; launches: its spec k = 4 serve (phase 6h; no k = 8 serve runs
    # on moe)
    spec_sq = (serve_info["moe"]["qwen3-moe-235b-a22b"]["spec_counts"]
               or {}).get("paged_attn_by_sq", {})
    for mode in ("bf16", "int8", "int4"):
        for sq in (SPEC_K + 1, 9):
            rows.append(_pa_row(
                dev, mode, sq, qcfg.n_heads_p, qcfg.n_kv_p, qcfg.head_dim_r,
                SERVE_P, lens, None, None,
                f"paged_attn_qwen3-moe_sq{sq}"
                f"{'' if mode == 'bf16' else '_' + mode}_p{SERVE_P}",
                ("f32 pools" if mode == "bf16" else f"{mode} pools + f32 "
                 f"scales") + f" (speculative verify, k={sq - 1})",
                spec_sq.get(sq, 0) if mode == "bf16" else 0, seed=11))
    # kernel 1 and kernel 2 at a rank's local shapes of phase 6k's TP
    # serves of qwen1.5-0.5b (column n/TP, row k/TP; 8/8 heads a rank);
    # launches: rank 0's continuous serves with f32, int8 and int4 pools
    tp = serve_info["tp"]["counts"]
    tp_shape = tp["bf16"]["encoded_matmul_by_shape"]
    prog = _program("exact")
    for m in (N_SLOTS, 32):
        for k, n in ((1024, 512), (1024, 1408), (512, 1024), (1408, 1024)):
            rows.append(_em_row(
                dev, prog, m, k, n, 13, f"encoded_matmul_tp{TP}_m{m}_k{k}_n{n}",
                tp_shape.get((m, k, n), 0),
                f"{'decode' if m == N_SLOTS else 'prefill'} at TP {TP}, a "
                f"rank's {'column' if k == 1024 else 'row'} shard; "
                "launches: rank 0's continuous serve", lib))
    for mode in ("bf16", "int8", "int4"):
        rows.append(_pa_row(
            dev, mode, 1, 16 // TP, 16 // TP, 64, SERVE_P, lens, None, None,
            f"paged_attn_tp{TP}{'' if mode == 'bf16' else '_' + mode}"
            f"_p{SERVE_P}",
            ("f32 pools" if mode == "bf16" else f"{mode} pools + f32 scales")
            + f", a rank's heads at TP {TP}", tp[mode]["paged_attn"],
            seed=12))
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
            f"launches on the main path {r['launches']}" + (
                f", in the static serve {r['launches_static']}"
                if "launches_static" in r else ""))
    per_step = serve_info["steps"] + serve_info["chunks"] + 2
    log(f"[measure] launches per engine forward (decode steps + prefill "
        f"chunks + the 2 graph warm-ups = {per_step}): encoded_matmul "
        f"{serve_info['counts']['encoded_matmul'] / per_step:.1f}, "
        f"paged_attn per decode forward "
        f"{serve_info['counts']['paged_attn'] / (serve_info['steps'] + 1):.1f}"
        f"; flash_attention {serve_info['counts']['flash_attention']} (not "
        "on the serving path)")
    return rows


_TIMING = re.compile(r"_ms|_s$|_s_|latency|ttft|tpot")


def _det_stats(st: dict) -> dict:
    """An engine's stats without its clocks (what every rank must
    share)."""
    return {k: v for k, v in st.items() if not _TIMING.search(k)}


def _splits_of(toks, base) -> dict:
    """{request: the first new token where ``toks`` parts from ``base``}."""
    return {i: j for i, j in _agreement(toks, base)[1]}


def _enc_sites(params, cfg, mesh=None):
    """id of every encoded linear's weight in ``params`` (the head, each
    layer's attention and MLP) → (site, its activation scale, whether
    the linear's input is a row shard under ``mesh``)."""
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import linear_role, splits
    with set_mesh(mesh):
        ways = splits(cfg)
    nodes = [("head", params.get("lm_head", {}), 1)] + [
        (f"layer {li} {sub}", layer[sub], ways.get(sub, 1))
        for li, layer in enumerate(params["layers"])
        for sub in ("attn", "mlp") if sub in layer]
    return {id(node[k]): (f"{where}/{k}", node[k + "_as"],
                          tp > 1 and linear_role(k) == "row")
            for where, node, tp in nodes for k in node if k + "_fw" in node}


def _recorded_serve(dev, params, cfg, trace, want, static, mesh=None,
                    **kw):
    """``trace`` served again eagerly (continuous; or ``static``: the
    chunks of ``N_SLOTS`` holding a request of ``want``) while a hook
    keeps request i's rows of every encoded linear's input, x / its
    activation scale, on the device (no sync while it serves), for each
    i of ``want`` ({request: new token where it split}): the prompt,
    then each token fed back, up to that token.  Under ``mesh`` (params:
    this rank's) a row shard's inputs are gathered after the serve.
    Returns ({i: {site: (positions, k) host tensor}}, the sites in call
    order)."""
    import numpy as np
    import torch
    from repro_torch.nn.common import activation_recorder
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.serve import supports_ragged_mask
    from repro_torch.serve.engine import StaticBatch, _ragged_pad
    from repro_torch.serve.scheduler import DECODING
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    sites = _enc_sites(params, cfg, mesh)
    order = []
    got = collections.defaultdict(lambda: collections.defaultdict(list))

    def recording(rows_of):
        def hook(name, w, x):
            if id(w) not in sites:
                return
            site, sa, _ = sites[id(w)]
            if site not in order:
                order.append(site)
            for i, pre, rows in rows_of(x):
                got[i][site].append((pre, rows.float() / sa))
        return activation_recorder(hook)

    if not static:
        eng, rids = _serve(params, cfg, trace, dev, mesh=mesh,
                           cuda_graphs=False if mesh is None else None,
                           **kw)
        cur, chunk_of = {}, eng._prefill_chunk

        def prefill_chunk(req):
            cur["rid"] = req.rid
            chunk_of(req)
            cur.pop("rid")
        eng._prefill_chunk = prefill_chunk
        of_rid = {rids[i]: i for i in want}

        def rows_of(x):
            if x.shape[1] > 1:
                i = of_rid.get(cur.get("rid"))
                return [] if i is None else [(i, True, x[0])]
            return [(i, False, x[eng.requests[rids[i]].slot]) for i in want
                    if eng.requests[rids[i]].state == DECODING]
        with torch.inference_mode(), recording(rows_of):
            eng.run()
        del eng._prefill_chunk, eng
    for c0 in (sorted({i - i % N_SLOTS for i in want}) if static else ()):
        chunk = trace[c0:c0 + N_SLOTS]
        S = max(map(len, chunk))
        batch = np.zeros((len(chunk), S), np.int32)
        pad = np.zeros((len(chunk),), np.int32)
        for r, q in enumerate(chunk):
            batch[r, S - len(q):] = q
            pad[r] = S - len(q)
        rows = {i - c0: i for i in want if c0 <= i < c0 + N_SLOTS}

        def rows_of(x, rows=rows, pad=pad):
            if x.shape[1] > 1:
                return [(i, True, x[r, int(pad[r]):]) for r, i in rows.items()]
            return [(i, False, x[r]) for r, i in rows.items()]
        with set_mesh(mesh), torch.inference_mode(), recording(rows_of):
            sb = StaticBatch(params, cfg, len(chunk), S + MAX_NEW + 8,
                             device=dev, graphs=False)
            sb.run(torch.from_numpy(batch),
                   max(want[i] for i in rows.values()) + 1,
                   pad=_ragged_pad(cfg, pad) if supports_ragged_mask(cfg)
                   else None)
        del sb
    gather = {site for site, _, g in sites.values() if g}
    out = {}
    for i, j in want.items():
        plen, pieces = len(trace[i]), got[i]
        out[i] = {}
        for site in order:
            t = torch.cat([torch.cat([r for pre, r in pieces[site] if pre])
                           [:plen]] + [r for pre, r in pieces[site]
                                       if not pre])[:plen + j]
            if site in gather:
                t = mesh.gather_columns(t.contiguous())
            out[i][site] = t.cpu()
    del got
    return out, order


def _tp_cont(mesh, dev, params, cfg, trace, base, tally=None, **kw):
    """One continuous serve on this rank (eager: a mesh runs no graph):
    tokens, seconds, stats, launch counts, collectives (in all, and per
    decode step with their host ms), whether every rank has the same
    tokens, stats and allocator state, and, where the tokens part from
    the single rank's ``base``, the parting requests' encoded inputs
    (``_recorded_serve``) for the parent to hold against that rank's.
    ``tally``: a ``_drop_tally``'s list, read before that rerun."""
    eng, rids = _serve(params, cfg, trace, dev, mesh=mesh,
                       max_new=len(base[0]), **kw)
    dec = eng.steps["decode"]
    fn, per = dec.fn, []

    def counted(*a):
        c0, s0 = mesh.collectives, mesh.collective_s
        out = fn(*a)
        per.append((mesh.collectives - c0, (mesh.collective_s - s0) * 1e3))
        return out
    dec.fn = counted
    c0, s0 = mesh.collectives, mesh.collective_s
    outs, dt, counts, st = _timed_run(eng, rids)
    toks = [outs[r].tolist() for r in rids]
    kv = eng.kv
    agree = mesh.agree((toks, _det_stats(st), kv.alloc.state(),
                        kv.ptab.tolist(), kv.lens.tolist()))
    res = {"tokens": toks, "dt": dt, "stats": st, "counts": counts,
           "agree": agree, "chunk": eng.prefill_chunk,
           "collectives": mesh.collectives - c0,
           "collective_ms": (mesh.collective_s - s0) * 1e3,
           "decode": per, "origins": None,
           "drops": None if tally is None else _drops(tally)}
    del eng, dec, fn
    splits = _splits_of(toks, base)
    if splits and agree and not kw.get("spec_decode"):
        res["origins"] = _recorded_serve(dev, params, cfg, trace, splits,
                                         False, mesh, max_new=len(base[0]),
                                         **kw)
    return res


def _tp_static(mesh, dev, params, cfg, trace, base, tally=None):
    """One ``ServeEngine`` serve on this rank (eager), as ``_tp_cont``."""
    c0, s0 = mesh.collectives, mesh.collective_s
    eng, toks, dt, counts = _static(params, cfg, trace, dev, mesh=mesh)
    st = eng.stats()
    res = {"tokens": toks, "dt": dt, "stats": st, "counts": counts,
           "chunks": eng.chunks, "agree": mesh.agree((toks, _det_stats(st))),
           "collectives": mesh.collectives - c0,
           "collective_ms": (mesh.collective_s - s0) * 1e3, "origins": None,
           "drops": None if tally is None else _drops(tally)}
    del eng
    splits = _splits_of(toks, base)
    if splits and res["agree"]:
        res["origins"] = _recorded_serve(dev, params, cfg, trace, splits,
                                         True, mesh)
    return res


def _tp_qwen(mesh, dev, bundle, base, ready=None):
    """Phase 6k's qwen1.5-0.5b on one rank: phase 6's exact bundle loaded
    (a cache hit), this rank's slices kept, ``ready()`` waited for, then
    the serves, each the whole trace to ``MAX_NEW`` new tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.serve import exact_encodings, prepare_encoded_serving
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              attention_backend="kernel")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device=dev)
    t_init = time.perf_counter() - t0
    params_enc, cfg_enc, info = prepare_encoded_serving(
        params, cfg, macs_override=exact_encodings(cfg.mac.bits),
        device=dev, cache_dir=bundle, verbose=False)
    torch.cuda.synchronize()
    out = {"init_s": t_init, "load_s": time.perf_counter() - t0 - t_init,
           "loaded": info["loaded"], "fw_whole": _fw_bytes(params_enc),
           "load_peak": torch.cuda.max_memory_allocated(dev)}
    local = shard_params(params_enc, cfg_enc, mesh)
    out["fw_local"] = _fw_bytes(local)
    t = local["embed"]["table"]
    out["embed_bytes"] = t.numel() * t.element_size()
    del params, params_enc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out["local_bytes"] = torch.cuda.memory_allocated(dev)
    if ready is not None:
        ready()
    trace = make_trace(cfg.vocab_size)
    _tp_cont(mesh, dev, local, cfg_enc, trace[:1], [base["bf16"][0][:4]])
    for key, kw, tr in (
            ("bf16", {}, trace),
            ("int8", {}, trace),
            ("int4", {}, trace),
            ("prefix", dict(prefix_cache=True),
             _prefix_trace(cfg.vocab_size)),
            ("spec", dict(spec_decode=SPEC_K), trace)):
        c = dataclasses.replace(cfg_enc, kv_cache_dtype=key) \
            if key in ("int8", "int4") else cfg_enc
        want = base["bf16" if key == "spec" else key]
        out[key] = _tp_cont(mesh, dev, local, c, tr, want, **kw)
    out["static"] = _tp_static(mesh, dev, local, cfg_enc, trace,
                               base["static"])
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def _tp_moe(mesh, dev, base):
    """Phase 6k's qwen3-moe on one rank: weights drawn and folded on the
    card as in 6h, one rank at a time, this rank's experts and slices
    kept; a rank's whole params (~40 GB, and its slices beside them while
    it cuts them) never meet another rank's slices on the card: a rank
    parks its slices on the host until every rank has cut its own.  Then
    the continuous engine (f32 pools) and ``ServeEngine``, each call's
    MoE drops tallied from its (whole) routing plan."""
    import torch
    from repro_torch.models import init_model, to_device
    from repro_torch.parallel.sharding import LocalParams, shard_params
    cfg = _moe_cfg("qwen3-moe-235b-a22b")
    out = {}
    with mesh.in_turns():
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_model(cfg, seed=0, device=dev, init_device=dev)
        params_enc, cfg_enc, _ = _fold_exact(params, cfg)
        torch.cuda.synchronize()
        out.update(build_s=time.perf_counter() - t0,
                   fw_whole=_fw_bytes(params_enc),
                   build_peak=torch.cuda.max_memory_allocated(dev))
        local = shard_params(params_enc, cfg_enc, mesh)
        out["fw_local"] = _fw_bytes(local)
        del params, params_enc
        local = to_device(local, "cpu")
        gc.collect()
    local = LocalParams(to_device(local, dev))
    torch.cuda.reset_peak_memory_stats(dev)
    out["local_bytes"] = torch.cuda.memory_allocated(dev)
    trace = make_trace(cfg.vocab_size)
    with _drop_tally(True) as tally:
        out["cont"] = _tp_cont(mesh, dev, local, cfg_enc, trace,
                               base["continuous"], tally=tally)
    with _drop_tally(True) as tally:
        out["static"] = _tp_static(mesh, dev, local, cfg_enc, trace,
                                   base["static"], tally=tally)
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["cfg"] = cfg_enc
    return out


# --- phase 6k's training on two ranks ----------------------------------------

# full-width qwen1.5-0.5b with the depth cut to 4 of 24 layers, AdamW,
# batch x seq tokens a step, the same seed and batches on every run
MESH_TRAIN_LAYERS, MESH_TRAIN_B, MESH_TRAIN_S = 4, 4, 256
# (run, mesh (data, model), MAC mode, steps, grad_compress, the parent's
# single-rank reference it is gated against)
MESH_TRAIN_RUNS = (("tp2", (1, TP), "fp", 3, False, "fp"),
                   ("tp2-encoded", (1, TP), "encoded-exact", 2, False,
                    "encoded-exact"),
                   ("dp2", (TP, 1), "fp", 3, False, "fp"),
                   ("dp2-gc", (TP, 1), "fp", 3, True, "gc"))
# the reference's mesh tolerances (tests/multidevice_script.py:30-37)
MESH_LOSS_TOL, MESH_PARAM_TOL = 1e-3, 2e-3
# the first moments: within this share of each leaf's max |value| (a few
# steps move a param by less than MESH_PARAM_TOL, the first at lr 0 under
# the warm-up; AdamW's m holds each step's clipped gradient).  The card's
# sharded products sum in another order than one rank's: f32 order took
# the exact-encoded TP-2 run's worst leaf to 1.05e-5 of its max with no
# int8 code moved (first card run of this gate); a 1% error in one
# leaf's gradient is ~1e-2 of it
MESH_MOMENT_TOL = 1e-4
# the compressed step's int8 scales, relative
MESH_SCALE_RTOL = 1e-5


def _mesh_train_cfg(mode):
    from repro_torch.serve import exact_encodings
    mac = exact_encodings()["wq"] if mode == "encoded-exact" else None
    return _train_cfg("encoded" if mac else mode, mac).with_layers(
        MESH_TRAIN_LAYERS)


def _mesh_batches(cfg, n):
    from repro_torch.data import SyntheticLMDataset
    ds = SyntheticLMDataset(cfg.vocab_size, MESH_TRAIN_S, seed=0)
    return [ds.batch(i, MESH_TRAIN_B) for i in range(n)]


def _mesh_train_run(dev, cfg, steps, mesh=None, grad_compress=False,
                    before=None, state=None, q0=None):
    """``steps`` train steps of ``cfg`` from seed 0's state (``state``:
    that logical state, made once for the runs that share it), under
    ``mesh`` (this rank's shards) or on one rank: losses, gnorms,
    host-clock ms a step (each ends in a sync), collectives / their host
    ms / bytes all-reduced a step, peak device memory, the final state.
    ``before(i, state)`` runs before step i; ``q0`` (a list, with
    ``grad_compress`` under a mesh without a model axis) receives the
    first step's values before int8 rounding (``_rounded_values``)."""
    import torch
    from repro_torch.optim.compression import init_error_buffers
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.statesharding import shard_state
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train import trainer as T
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    if state is None:
        state = init_train_state(cfg, seed=0, device=dev)
    st = dict(state)
    if grad_compress:
        st["err"] = init_error_buffers(st["params"])
    if mesh is not None:
        st = shard_state(st, cfg, mesh)
    step = make_train_step(cfg, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS,
                           grad_compress=grad_compress)
    out = {"losses": [], "gnorms": [], "ms": [], "coll": []}
    orig = T.compressed_allreduce

    def recorded(grads, err, mesh_):
        if not q0:
            q0.extend(_rounded_values(grads, err, mesh_))
        return orig(grads, err, mesh_)
    if q0 is not None:
        T.compressed_allreduce = recorded
    with set_mesh(mesh), contextlib.ExitStack() as undo:
        undo.callback(setattr, T, "compressed_allreduce", orig)
        for i, b in enumerate(_mesh_batches(cfg, steps)):
            if before is not None:
                before(i, st)
            c0 = mesh.counters() if mesh is not None else (0, 0.0, 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            st, m = step(st, b)
            out["losses"].append(float(m["loss"]))
            out["gnorms"].append(float(m["gnorm"]))
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t) * 1e3)
            c1 = mesh.counters() if mesh is not None else (0, 0.0, 0)
            out["coll"].append((c1[0] - c0[0], (c1[1] - c0[1]) * 1e3,
                                c1[2] - c0[2]))
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["state"] = st
    return out


def _rounded_values(grads, err, mesh):
    """Each leaf's error-corrected gradient over its int8 scale, as
    ``optim.compression.ef_compress_tree`` rounds it (whole leaves: no
    model axis), on the host, with the scale: [(values, scale)]."""
    import torch
    from repro_torch.tree import tree_leaves
    if mesh.n_model != 1:
        raise ValueError("the compressed values are recorded on whole "
                         "leaves only")
    out = []
    for g, e in zip(tree_leaves(grads), tree_leaves(err)):
        x = g.to(torch.float32) + e
        s = torch.clamp_min(x.abs().amax(), 1e-12) / 127.0
        out.append(((x / s).cpu(), s.item()))
    return out


def _named_leaves(tree, prefix=""):
    """(path, leaf) of a tree of dicts in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _moment_excess(want, got, cfg=None, mesh=None) -> tuple:
    """(max over leaves of max |got - want| - ``MESH_MOMENT_TOL`` · max
    |want| (<= 0 passes), the worst leaf's max |got - want| / max |want|,
    its path) for two trees of first moments on one device: ``want``
    logical, ``got`` whole or, under ``mesh``, this rank's shards, each
    leaf's figures then the max over every rank."""
    import torch
    from repro_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL
    from repro_torch.parallel.statesharding import shard_state
    from repro_torch.tree import tree_leaves
    cut = want if mesh is None else \
        shard_state({"params": want}, cfg, mesh)["params"]
    names, excess, rel = [], [], []
    for (name, w), c, g in zip(_named_leaves(want), tree_leaves(cut),
                               tree_leaves(got)):
        top = w.float().abs().max().item()
        d = (g.float() - c.float()).abs().max().item()
        names.append(name)
        excess.append(d - MESH_MOMENT_TOL * top)
        rel.append(d / max(top, 1e-30))
    t = torch.tensor([excess, rel], dtype=torch.float64)
    if mesh is not None:
        t = mesh.all_reduce_max(mesh.all_reduce_max(t, AXIS_MODEL),
                                AXIS_DATA)
    worst = int(t[1].argmax())
    return t[0].max().item(), t[1, worst].item(), names[worst]


def _codes_apart(want, got, dev) -> tuple:
    """Two first compressed steps' values before rounding
    (``_rounded_values``): (int8 codes apart, of all, their max distance
    from the .5 boundary on either side, the worst leaf's relative scale
    difference)."""
    import torch
    n = total = 0
    edge = scale = 0.0
    for (a, sa), (b, sb) in zip(want, got):
        a, b = a.to(dev), b.to(dev)
        ca = torch.clamp(torch.round(a), -127, 127)
        cb = torch.clamp(torch.round(b), -127, 127)
        apart = ca != cb
        k = int(apart.sum())
        n, total = n + k, total + a.numel()
        if k:
            e = torch.maximum((a[apart] - a[apart].floor() - 0.5).abs(),
                              (b[apart] - b[apart].floor() - 0.5).abs())
            edge = max(edge, e.max().item())
        scale = max(scale, abs(sb - sa) / sa)
    return n, total, edge, scale


def _param_excess(ref, got) -> tuple:
    """(max over leaves of max(|got - ref| - tol - tol·|ref|), max |got -
    ref|) for two param trees on one device, tol = ``MESH_PARAM_TOL``."""
    from repro_torch.tree import tree_leaves
    worst = diff = -math.inf
    for a, b in zip(tree_leaves(ref), tree_leaves(got)):
        d = (b.float() - a.float()).abs()
        worst = max(worst, (d - MESH_PARAM_TOL
                            - MESH_PARAM_TOL * a.float().abs()).max().item())
        diff = max(diff, d.max().item())
    return worst, diff


def _digest(tree) -> list:
    """sha1 of each leaf's bytes (host tensors)."""
    import hashlib
    import torch
    from repro_torch.tree import tree_leaves
    return [hashlib.sha1(t.contiguous().view(-1).view(torch.uint8).numpy()
                         .tobytes()).hexdigest() for t in tree_leaves(tree)]


def _wait_refs(job):
    """Wait for the parent's single-rank training references (run while
    the ranks start and load their weights), so no rank serves or trains
    before they are done."""
    deadline = time.monotonic() + 1200
    while not os.path.exists(job["done"]):
        if time.monotonic() > deadline:
            raise TimeoutError("the parent's references never came")
        time.sleep(0.5)
    with open(job["done"]) as f:
        if f.read() != "ok":
            raise RuntimeError("the parent's references failed")


def _tp_train(mesh, dev, job):
    """Phase 6k's training on this rank, after the serves: each run of
    ``MESH_TRAIN_RUNS`` on its mesh (``mesh``, 1 x TP, or a TP x 1 mesh
    over the same ranks), its params gathered and held
    against the parent's single-rank reference (``job["refs"]``), every
    rank's digest of them compared, and its first moments against the
    reference's shard by shard (``_moment_excess``); a compressed run's
    first step's values before int8 rounding written by rank 0 and its
    error buffers compared over the ranks; the tp2 state written whole by
    rank 0 as a checkpoint (``job["ckpt"]``) for the parent's restore.
    Where an encoded run parts from its reference, rank 0 writes each
    step's linear inputs (from the params it kept before each step) for
    the parent's search of a code f32 order moved."""
    import torch
    from repro_torch.ckpt import save_checkpoint
    from repro_torch.models import to_device
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.statesharding import gather_state
    from repro_torch.train import init_train_state
    from repro_torch.tree import tree_leaves
    meshes = {(1, TP): mesh, (TP, 1): Mesh(TP, 1)}
    # the fp runs share seed 0's logical state (the step leaves it intact)
    fp0 = init_train_state(_mesh_train_cfg("fp"), seed=0, device=dev)
    out = {}
    for name, shape, mode, steps, gcomp, ref in MESH_TRAIN_RUNS:
        m = meshes[shape]
        cfg = _mesh_train_cfg(mode)
        befores = []
        q0 = [] if gcomp and m.rank == 0 else None
        r = _mesh_train_run(
            dev, cfg, steps, m, gcomp,
            (lambda i, st: befores.append(
                {"params": to_device(st["params"], "cpu")}))
            if mode != "fp" else None, fp0 if mode == "fp" else None, q0)
        st = r.pop("state")
        params = gather_state({"params": st["params"]}, cfg, m)["params"]
        want = torch.load(job["refs"][ref], map_location=dev)
        r["excess"], r["maxdiff"] = _param_excess(want["params"], params)
        r["agree"] = m.agree(_digest(to_device(params, "cpu")))
        # a compressed run's moments hold its codes, gated at step 0
        # instead (``_codes_apart``): f32 order moves some across .5
        r["m_excess"], r["m_rel"], r["m_leaf"] = (-math.inf, 0.0, "") \
            if gcomp else _moment_excess(want["m"], st["opt"]["m"], cfg, m)
        r["recs"] = []
        if gcomp:
            err = to_device(st["err"], "cpu")
            r["err_agree"] = m.agree(_digest(err))
            r["err_max"] = max(e.abs().max().item() for e in
                               tree_leaves(err))
            r["q0"] = os.path.join(job["dir"], f"{name}-q0.pt")
            if m.rank == 0:
                torch.save(q0, r["q0"])
            del err, q0
        parted = r["excess"] > 0 or r["m_excess"] > 0 or max(
            abs(a - b) for a, b in zip(r["losses"], want["losses"])) > \
            MESH_LOSS_TOL
        if parted and mode != "fp":
            for i, b in enumerate(_mesh_batches(cfg, steps)):
                x = _linear_inputs(dev, cfg, befores[i], b["tokens"], m)
                if m.rank == 0:
                    path = os.path.join(job["dir"], f"{name}-inputs-{i}.pt")
                    torch.save(x, path)
                    r["recs"].append(path)
        if name == "tp2":
            whole = gather_state(st, cfg, m, device="cpu")
            if m.rank == 0:
                save_checkpoint(job["ckpt"], steps, whole)
            m.barrier()
            del whole
        out[name] = r
        del st, params, want, befores
        gc.collect()
        torch.cuda.empty_cache()
    del fp0
    return out


def _mesh_train_refs(dev, paths, done):
    """The parent's single-rank references of ``MESH_TRAIN_RUNS``: fp,
    exact-encoded and (through a 1 x 1 mesh of this process alone, where
    the step quantizes at n = 1: the reference's single-device chain)
    grad-compressed; each run's final params, first moments and losses
    written to ``paths`` for the ranks, then ``done`` ("ok", or "failed"
    if a run raised).  The fp state stays (on the host) for the elastic
    restore, the encoded run's params before each step for a parting's
    search, the compressed run's first step's values before rounding."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import to_device
    from repro_torch.parallel.mesh import Mesh, _free_port
    from repro_torch.train import init_train_state
    refs = {}
    try:
        fp0 = init_train_state(_mesh_train_cfg("fp"), seed=0, device=dev)
        for key, mode, steps, gcomp in (("fp", "fp", 3, False),
                                        ("encoded-exact", "encoded-exact", 2,
                                         False), ("gc", "fp", 3, True)):
            cfg = _mesh_train_cfg(mode)
            mesh, befores, q0 = None, [], [] if gcomp else None
            if gcomp:
                dist.init_process_group(
                    "gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                    rank=0, world_size=1)
                mesh = Mesh(1, 1)
            try:
                r = _mesh_train_run(
                    dev, cfg, steps, mesh, gcomp,
                    (lambda i, st: befores.append(
                        {"params": to_device(st["params"], "cpu")}))
                    if mode != "fp" else None, fp0 if mode == "fp" else None,
                    q0)
            finally:
                if gcomp:
                    dist.destroy_process_group()
            st = r.pop("state")
            torch.save({"params": to_device(st["params"], "cpu"),
                        "m": to_device(st["opt"]["m"], "cpu"),
                        "losses": r["losses"]}, paths[key])
            r["state"] = to_device(st, "cpu") if key == "fp" else None
            r["befores"], r["q0"] = befores, q0
            refs[key] = r
            del st
            gc.collect()
            torch.cuda.empty_cache()
        del fp0
    except BaseException:
        with open(done, "w") as f:
            f.write("failed")
        raise
    with open(done, "w") as f:
        f.write("ok")
    return refs


def _mesh_train_check(dev, res, refs, ckpt):
    """Gate phase 6k's training runs against the single-rank references
    and the elastic restore (see ``phase_tp``)."""
    import torch
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.models import to_device
    from repro_torch.train import init_train_state, make_train_step
    for name, shape, mode, steps, gcomp, ref in MESH_TRAIN_RUNS:
        r, one = res[name], refs[ref]
        cs = [c for c, _, _ in r["coll"]]
        hs = [h for _, h, _ in r["coll"]]
        bs = [b for _, _, b in r["coll"]]
        dl = max(abs(a - b) for a, b in zip(r["losses"], one["losses"]))
        log(f"[tp-train] {name} (mesh {shape[0]}x{shape[1]}, {mode}"
            f"{', grad_compress' if gcomp else ''}, {steps} steps of "
            f"{MESH_TRAIN_B}x{MESH_TRAIN_S}, {MESH_TRAIN_LAYERS} of 24 "
            f"layers): losses {[round(x, 5) for x in r['losses']]} against "
            f"one rank's {[round(x, 5) for x in one['losses']]} (max |diff| "
            f"{dl:.2e}); step ms p50 {_p50(r['ms'][1:] or r['ms']):.1f} "
            f"(steps {[round(x, 1) for x in r['ms']]}), one rank "
            f"{_p50(one['ms'][1:] or one['ms']):.1f} (run as the ranks load "
            f"their weights); a step: "
            f"{_p50(cs):.0f} collectives, {_p50(hs):.1f} ms of them on the "
            f"host, {_p50(bs) / 1e6:.1f} MB all-reduced; peak device "
            f"memory a rank {r['peak'] / 1e9:.2f} GB (one rank "
            f"{one['peak'] / 1e9:.2f} GB); params max |diff| "
            f"{r['maxdiff']:.2e}, excess over rtol=atol={MESH_PARAM_TOL} "
            f"{r['excess']:.2e} (<= 0 passes); "
            + ("" if gcomp else
               f"first moments worst leaf {r['m_leaf']} max |diff| / max "
               f"{r['m_rel']:.2e}, excess over {MESH_MOMENT_TOL} of the max "
               f"{r['m_excess']:.2e} (<= 0 passes); ")
            + f"ranks agree {r['agree']} ({SMI})")
        if not r["agree"]:
            raise AssertionError(f"[tp-train] {name}: the ranks' states "
                                 "differ")
        if not all(map(math.isfinite, r["losses"] + r["gnorms"])):
            raise AssertionError(f"[tp-train] {name}: non-finite losses")
        if gcomp:
            # the first compressed step starts from one state on both
            # sides: its int8 codes must be the single rank's but where
            # f32 order moved a value across .5, its scales within
            # MESH_MOMENT_TOL; the error buffers non-zero, equal on the ranks
            n, total, edge, scale = _codes_apart(one["q0"],
                                                 torch.load(r["q0"]), dev)
            log(f"[tp-train] {name}: step 0's int8 codes against one "
                f"rank's: {n} of {total} apart, at most {edge:.2e} from "
                f".5 (<= {ORIGIN_TOL} passes); scales rel {scale:.2e}; the "
                f"error buffers max |err| {r['err_max']:.3e}, equal on the "
                f"ranks {r['err_agree']}")
            if edge > ORIGIN_TOL or scale > MESH_SCALE_RTOL or total == 0:
                raise AssertionError(f"[tp-train] {name}: the compressed "
                                     "step's codes part from one rank's")
            if not r["err_agree"] or not r["err_max"] > 0:
                raise AssertionError(f"[tp-train] {name}: the error buffers "
                                     "are zero or differ over the ranks")
        if dl <= MESH_LOSS_TOL and r["excess"] <= 0 and r["m_excess"] <= 0:
            continue
        if mode == "fp":
            raise AssertionError(f"[tp-train] {name}: parts from one rank "
                                 f"(loss {dl:.2e}, params {r['excess']:.2e}"
                                 f", first moments {r['m_excess']:.2e})")
        # an encoded parting must start at a code f32 order moved across
        # a .5 boundary: the first step whose two forwards differ in a code
        cfg = _mesh_train_cfg(mode)
        flip = None
        if not r["recs"]:
            raise AssertionError(f"[tp-train] {name}: parts from one rank "
                                 "and recorded no inputs")
        for i, path in enumerate(r["recs"]):
            mine = torch.load(path)
            theirs = _linear_inputs(dev, cfg, one["befores"][i],
                                    _mesh_batches(cfg, i + 1)[i]["tokens"])
            flip = _first_flip(theirs, mine)
            if flip is not None:
                flip = (i,) + flip
                break
        edge = None if flip is None else max(
            abs(v - math.floor(v) - 0.5) for v in flip[2:4])
        log(f"[tp-train] {name}: parts from one rank; the first int8 code "
            f"apart (step, site, one rank, TP {TP}): {flip}, {edge} from "
            f"the .5 boundary")
        if flip is None or edge > ORIGIN_TOL:
            raise AssertionError(f"[tp-train] {name}: a parting without a "
                                 "rounding-boundary origin")
    # elastic: the tp2 state, written by rank 0 as one logical checkpoint,
    # restored here on one rank; its next step against the single-rank
    # step from the single rank's own state after the same steps
    cfg = _mesh_train_cfg("fp")
    steps = MESH_TRAIN_RUNS[0][3]
    b = _mesh_batches(cfg, steps + 1)[steps]
    t = time.perf_counter()
    back = restore_checkpoint(ckpt, steps,
                              init_train_state(cfg, seed=1, device=dev))
    read_s = time.perf_counter() - t
    step = make_train_step(cfg, warmup=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    s_tp, m_tp = step(back, b)
    del back
    s_one, m_one = step(to_device(refs["fp"]["state"], dev), b)
    worst, diff = _param_excess(s_one["params"], s_tp["params"])
    m_worst, m_rel, m_leaf = _moment_excess(s_one["opt"]["m"],
                                            s_tp["opt"]["m"])
    dl = abs(float(m_tp["loss"]) - float(m_one["loss"]))
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(ckpt) for f in fs)
    log(f"[tp-train] elastic: the tp2 state after {steps} steps (checkpoint "
        f"{size / 1e9:.2f} GB, logical, by rank 0) restored on one rank in "
        f"{read_s:.1f}s; its next step's loss {float(m_tp['loss']):.6f} "
        f"against the single rank's {float(m_one['loss']):.6f} (|diff| "
        f"{dl:.2e}); params max |diff| {diff:.2e}, excess {worst:.2e}; "
        f"first moments worst leaf {m_leaf} rel {m_rel:.2e}, excess "
        f"{m_worst:.2e} "
        f"(<= 0 passes)")
    if dl > MESH_LOSS_TOL or worst > 0 or m_worst > 0:
        raise AssertionError("[tp-train] elastic: the restored state's step "
                             "parts from the single rank's")
    del s_tp, s_one
    gc.collect()
    torch.cuda.empty_cache()


def _tp_rank(mesh, job):
    """Phase 6k on one rank of ``TP``: qwen1.5-0.5b, then qwen3-moe, each
    served once the parent's training references are done (they run as
    the ranks start and load); then training (``_tp_train``), the serve
    state freed."""
    import torch
    dev = torch.device("cuda", 0)
    out = {"qwen": _tp_qwen(mesh, dev, job["bundle"], job["base"],
                            functools.partial(_wait_refs, job["train"]))}
    gc.collect()
    torch.cuda.empty_cache()
    out["moe"] = _tp_moe(mesh, dev, job["base"]["moe"])
    gc.collect()
    torch.cuda.empty_cache()
    out["train"] = _tp_train(mesh, dev, job["train"])
    return out


def _tp_origins(tag, dev, params, cfg, trace, base, r, static, **kw):
    """Where the TP serve ``r`` parts from the single rank's ``base``,
    gated as ``_split_report`` gates two engines: the single rank's serve
    again eagerly with the same hook (``_recorded_serve``), and for each
    parting request the first position, and the first site in forward
    order there, whose int8 code differs; it must sit within
    ``ORIGIN_TOL`` of a .5 boundary on both sides with every earlier
    input within ``ORIGIN_TOL``, or, with no code moved, the split must
    be a near-tie (``FP_TIE_RTOL`` of the largest |logit|)."""
    import numpy as np
    import torch
    splits = _splits_of(r["tokens"], base)
    if r["origins"] is None:
        raise AssertionError(f"[tp] {tag}: tokens part from the single-rank "
                             f"eager serve at {splits}, and no origin was "
                             "recorded")
    tp_rows, order = r["origins"]
    one_rows, order1 = _recorded_serve(dev, params, cfg, trace, splits,
                                       static, **kw)
    assert order == order1, f"[tp] {tag}: the sites run in another order"

    def code(t):
        return torch.clamp(torch.round(t), -127, 127)
    for i, j in splits.items():
        xs, xt = one_rows[i], tp_rows[i]
        diff = torch.stack([(code(xs[t]) != code(xt[t])).any(dim=1)
                            for t in order])
        hit = diff.any(dim=0).nonzero()
        if len(hit) == 0:
            toks = np.concatenate([trace[i], np.asarray(base[i][:j],
                                                        np.int32)])
            lg, _ = _routes(params, cfg, toks, dev)
            top = max(v.abs().max().item() for v in lg.values())
            rel = max(abs((v[base[i][j]] - v[r["tokens"][i][j]]).item())
                      for v in lg.values()) / top
            log(f"[tp-origin] {tag}: request {i} parts at new token {j} "
                f"with no int8 code different; margin {rel:.2e} of "
                f"max|logit|")
            if rel > FP_TIE_RTOL:
                raise AssertionError(f"[tp] {tag}: request {i} parts at {j} "
                                     "without a moved code or a near-tie")
            continue
        p = int(hit[0])
        t = order[int(diff[:, p].nonzero()[0])]
        chans = (code(xs[t][p]) != code(xt[t][p])).nonzero()[:, 0].tolist()
        edge = max(abs(v - math.floor(v) - 0.5) for c in chans
                   for v in (xs[t][p, c].item(), xt[t][p, c].item()))
        before = max([(xs[u][:p] - xt[u][:p]).abs().max().item()
                      for u in order if p] + [
            (xs[u][p] - xt[u][p]).abs().max().item()
            for u in order[:order.index(t)]] + [0.0])
        plen = len(trace[i])
        where = (f"prompt position {p}" if p < plen
                 else f"new token {p - plen} fed back")
        log(f"[tp-origin] {tag}: request {i} (prompt {plen}) parts at new "
            f"token {j}; the first int8 code apart is at {where}, {t} "
            f"channel(s) {chans[:4]}: x / scale "
            f"{xs[t][p, chans[0]].item():.7f} (1 rank) against "
            f"{xt[t][p, chans[0]].item():.7f} (TP {TP}), {edge:.1e} from the "
            f".5 boundary; every input to there within {before:.3e}")
        if edge > ORIGIN_TOL or before > ORIGIN_TOL:
            raise AssertionError(f"[tp] {tag}: request {i} parts without a "
                                 f"rounding-boundary origin ({edge:.2e}, "
                                 f"{before:.2e})")
    log(f"[tp-origin] {tag}: every split starts at a code f32 order moved "
        f"across a .5 boundary (within {ORIGIN_TOL}) or at a near-tie")


def _tp_check(tag, r, base, cfg, eager_tok_s, static=False):
    """Log one phase 6k serve and gate what needs no single-rank rerun:
    every request finished, the ranks agree.  Returns whether its tokens
    part from the single rank's ``base``."""
    toks = r["tokens"]
    n_tok = sum(map(len, toks))
    if not r["agree"]:
        raise AssertionError(f"[tp] {tag}: the ranks' tokens, stats or "
                             "allocator state differ")
    assert len(toks) == len(base) and all(
        len(t) == len(b) and all(0 <= x < cfg.vocab_size for x in t)
        for t, b in zip(toks, base)), f"[tp] {tag}: not every request " \
        "finished"
    n_same, parts = _agreement(toks, base)
    dec = r.get("decode") or []
    per = ""
    if dec:
        cs = sorted(c for c, _ in dec)
        ms = sorted(t for _, t in dec)
        per = (f"; a decode step: {cs[len(cs) // 2]} collectives (min "
               f"{cs[0]}, max {cs[-1]}), {ms[len(ms) // 2]:.3f} ms of them "
               f"on the host (p50; max {ms[-1]:.3f}) over {len(dec)} steps")
    st = r["stats"]
    log(f"[tp] {tag}: {len(toks)} requests, {n_tok} tokens in {r['dt']:.3f}s"
        f" = {n_tok / r['dt']:.1f} tok/s eager at TP {TP} (single-rank eager "
        f"{'not served' if eager_tok_s is None else round(eager_tok_s, 1)});"
        f" step p50 {st['step_ms_p50']:.2f} ms; collectives "
        f"{r['collectives']} in all, {r['collective_ms']:.1f} ms on the host"
        f"{per}; ranks agree on tokens, stats"
        f"{'' if static else ' and allocator state'}; tokens against the "
        f"single-rank eager serve: {n_same} of {len(toks)} requests "
        f"identical, parts (request, new token) {parts}; {SMI}")
    return bool(parts)


def phase_tp(dev, info):
    """Phase 6k: ``TP`` ranks over gloo on the one card
    (``parallel.mesh.run_ranks``; the kernels were built here, the ranks
    load them), each serving as one rank of the mesh (``_tp_rank``);
    gated here against the single-rank eager serves of phases 6, 6c, 6d,
    6e and 6h (a split must start where ``_tp_origins`` finds f32 order
    moving a code across .5, or at a near-tie)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    from repro_torch.parallel.mesh import run_ranks
    gc.collect()
    torch.cuda.empty_cache()
    base = info["tp_base"]
    log(f"[tp] this process holds {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
        f" GB of the card ({torch.cuda.memory_reserved(dev) / 1e9:.2f} GB "
        "reserved) as the ranks start")
    tmp = bundle_dir("tp-train")
    job = {"bundle": info["bundle"], "base": base, "train": {
        "refs": {k: os.path.join(tmp, f"ref-{k}.pt")
                 for k in ("fp", "encoded-exact", "gc")},
        "done": os.path.join(tmp, "refs-done"),
        "ckpt": os.path.join(tmp, "ckpt"), "dir": tmp}}
    # the single-rank training references run here while the ranks
    # start and load their weights; the ranks wait for them before they
    # serve (``_wait_refs``)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_ranks, _tp_rank, TP, job, device=str(dev))
        refs = _mesh_train_refs(dev, job["train"]["refs"],
                                job["train"]["done"])
        log(f"[tp-train] the single-rank references in "
            f"{time.perf_counter() - t0:.1f}s, as the ranks start")
        res = fut.result()
    log(f"[tp] {TP} ranks spawned, served, trained and joined in "
        f"{time.perf_counter() - t0:.1f}s")
    ckpt = job["train"]["ckpt"]
    try:
        _mesh_train_check(dev, res["train"], refs, ckpt)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del refs
    q = res["qwen"]
    log(f"[tp] qwen1.5-0.5b: a rank's init {q['init_s']:.1f}s, phase 6's "
        f"bundle {'loaded (cache hit)' if q['loaded'] else 'NOT a cache hit'}"
        f" in {q['load_s']:.1f}s (both ranks at once; peak "
        f"{q['load_peak'] / 1e9:.2f} GB a rank); folded bf16 Wt a rank "
        f"{q['fw_local'] / 1e9:.4f} GB of {q['fw_whole'] / 1e9:.4f}; a "
        f"rank's params on the card {q['local_bytes'] / 1e9:.2f} GB (the "
        f"rank's rows of the embedding {q['embed_bytes'] / 1e9:.4f} GB of "
        f"them), "
        f"serving peak {q['peak'] / 1e9:.2f} GB; {SMI}")
    if not q["loaded"]:
        raise AssertionError("phase 6's bundle was not a cache hit under "
                             "the mesh")
    if q["fw_local"] * TP != q["fw_whole"]:
        raise AssertionError("a rank's folded bytes are not 1/TP of the "
                             "whole")
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"),
                              attention_backend="kernel")
    trace = make_trace(cfg.vocab_size)
    eager = base["eager_tok_s"]
    parted = []
    counts = {}
    for tag, key in (("continuous f32 pools", "bf16"),
                     ("continuous int8 pools", "int8"),
                     ("continuous int4 pools", "int4"),
                     ("prefix cache (6c's trace)", "prefix"),
                     (f"spec self k={SPEC_K}", "spec")):
        r = q[key]
        ck = dataclasses.replace(cfg, kv_cache_dtype=key) \
            if key in ("int8", "int4") else cfg
        _check_counts(r["counts"], r["stats"], ck, r["chunk"],
                      f"(tp {tag}, rank 0)", gated=True, tp=TP)
        want = base["bf16" if key == "spec" else key]
        if _tp_check(tag, r, want, cfg, eager.get(key)):
            parted.append((tag, key, want, r))
        if key == "prefix" and r["stats"]["prefix_hit_tokens"] <= 0:
            raise AssertionError("[tp] the shared-prefix trace had no hit")
        counts[key] = r["counts"]
    r = q["static"]
    _check_static_counts(r["counts"], r["chunks"], cfg, "(tp static, rank 0)",
                         gated=True, tp=TP)
    if _tp_check("static", r, base["static"], cfg, eager["static"],
                 static=True):
        parted.append(("static", "static", base["static"], r))
    counts["static"] = r["counts"]
    if parted:                    # the single rank's serves again, hooked
        # phase 6's params, folded here again (the bundle holds this fold)
        params = init_model(cfg, seed=0, device=dev)
        pe, ce, _ = _fold_exact(params, cfg)
        for tag, key, want, r in parted:
            c = dataclasses.replace(ce, kv_cache_dtype=key) \
                if key in ("int8", "int4") else ce
            tr = (_prefix_trace(cfg.vocab_size) if key == "prefix"
                  else trace[:len(want)])
            kw = {} if key == "static" else dict(max_new=len(want[0]))
            if key == "prefix":
                kw["prefix_cache"] = True
            _tp_origins(tag, dev, pe, c, tr, want, r, key == "static", **kw)
        del params, pe
        gc.collect()
        torch.cuda.empty_cache()
    m = res["moe"]
    mb = base["moe"]
    cfg_m = m["cfg"]
    log(f"[tp] qwen3-moe ({cfg_m.n_layers} layers, EP: {cfg_m.n_experts // TP}"
        f" experts a rank): built and folded in turns, {m['build_s']:.1f}s a "
        f"rank (peak {m['build_peak'] / 1e9:.2f} GB); folded bf16 Wt a rank "
        f"{m['fw_local'] / 1e9:.4f} GB of {m['fw_whole'] / 1e9:.4f}; a "
        f"rank's params {m['local_bytes'] / 1e9:.2f} GB, serving peak "
        f"{m['peak'] / 1e9:.2f} GB; {SMI}")
    parted = []
    for tag, key, want, drops, eager in (
            ("qwen3-moe continuous f32 pools", "cont", mb["continuous"],
             mb["drops_continuous"], mb["eager_tok_s"]["continuous"]),
            ("qwen3-moe static", "static", mb["static"], mb["drops_static"],
             mb["eager_tok_s"]["static"])):
        r = m[key]
        if key == "cont":
            _check_counts(r["counts"], r["stats"], cfg_m, r["chunk"],
                          f"(tp {tag}, rank 0)", gated=True, tp=TP)
        else:
            _check_static_counts(r["counts"], r["chunks"], cfg_m,
                                 f"(tp {tag}, rank 0)", gated=True, tp=TP)
        split = _tp_check(tag, r, want, cfg_m, eager, static=key == "static")
        log(f"[tp] {tag}: MoE drops (pairs dropped, pairs) {r['drops']}, "
            f"single-rank eager (6h) {drops}")
        if split:
            parted.append((tag, key, want, r))
        elif r["drops"] != drops:
            raise AssertionError(f"[tp] {tag}: MoE drops differ from 6h's")
        counts["moe_" + key] = r["counts"]
    if parted:
        cfg0 = _moe_cfg("qwen3-moe-235b-a22b")
        params = init_model(cfg0, seed=0, device=dev, init_device=dev)
        pe, ce, _ = _fold_exact(params, cfg0)
        for tag, key, want, r in parted:
            _tp_origins(tag, dev, pe, ce, make_trace(cfg0.vocab_size), want,
                        r, key == "static")
        del params, pe
        gc.collect()
        torch.cuda.empty_cache()
    return {"counts": counts}


# phase 10 (the paper's conv net): card against the CPU at a reduced
# size (images, train split, epochs, fine-tune steps)
PAPER_REDUCED = (600, 500, 1, 5)
# Table 2 on the card: fp accuracy at least this (the reference's CPU
# run: 0.998), int8 within PAPER_INT8_TOL of fp, the exact encoding
# within PAPER_EXACT_TOL of int8 (it computes int8's products exactly)
PAPER_FP_MIN, PAPER_INT8_TOL, PAPER_EXACT_TOL = 0.9, 0.01, 0.002
# card against CPU: fp logits within this share of max|logit|; trained
# params within this of each other (the CPU tests' train tolerance)
PAPER_LOGIT_RTOL, PAPER_PARAM_ATOL = 1e-4, 2e-3
PAPER_LAYERS = ("c1", "c2", "c3", "d1", "d2")


def _cnn_numpy_init(seed: int = 0) -> dict:
    """The CNN's initial weights drawn with numpy at ``cnn_init``'s shapes
    and scales (one tree carried to both devices)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shapes = {"c1": (27, 16), "c2": (144, 16), "c3": (144, 32),
              "d1": (512, 64), "d2": (64, 10)}
    return {k: {"w": (rng.normal(size=s) / np.sqrt(s[0])).astype(
        np.float32)} for k, s in shapes.items()}


def _cnn_codes(params, x, mcfg):
    """Each layer's input over its activation scale, in forward order,
    for images ``x`` (numpy), on the params' device; returned on the
    host."""
    import torch
    from repro_torch.apps.image_cls import cnn_apply
    from repro_torch.nn.common import activation_recorder
    got = []
    dev = params["c1"]["w"].device
    with torch.no_grad(), activation_recorder(
            lambda name, w, a: got.append(a.reshape(-1).cpu())):
        cnn_apply(params, torch.from_numpy(x).to(dev), mcfg)
    return [g / params[k]["a_scale"].cpu()
            for k, g in zip(PAPER_LAYERS, got)]


def _paper_split_origin(pc, pg, mcfg, x, logits_cpu):
    """Why card and CPU predict one image differently: the first layer
    whose int8 input codes differ, both values within ``ORIGIN_TOL`` of a
    .5 boundary; with no code apart, a near-tie of the CPU's two top
    logits (``FP_TIE_RTOL``).  Raises otherwise."""
    import torch
    for k, a, b in zip(PAPER_LAYERS, _cnn_codes(pc, x, mcfg),
                       _cnn_codes(pg, x, mcfg)):
        apart = torch.nonzero(torch.round(a) != torch.round(b)).reshape(-1)
        if apart.numel():
            i = int(apart[0])
            va, vb = float(a[i]), float(b[i])
            off = max(abs(abs(v) % 1.0 - 0.5) for v in (va, vb))
            log(f"[paper] split origin: layer {k} input {i}: CPU {va:.6f}, "
                f"card {vb:.6f} ({off:.2e} from .5; {apart.numel()} codes "
                f"apart in that layer)")
            if off > ORIGIN_TOL:
                raise AssertionError(f"paper: card and CPU codes part at "
                                     f"{k} away from .5 ({va}, {vb})")
            return
    top = torch.sort(logits_cpu).values[-2:]
    gap = float(top[1] - top[0]) / float(logits_cpu.abs().max())
    log(f"[paper] split without a code apart: top-2 logit gap {gap:.2e} "
        f"of max|logit|")
    if gap > FP_TIE_RTOL:
        raise AssertionError(f"paper: card and CPU part without a code "
                             f"apart or a near-tie ({gap})")


def _paper_card_cpu(dev, exact):
    """Phase 10 (a): the reduced Table 2 pipeline on the card and on the
    CPU from one numpy-drawn init: fp training (losses within
    ``CARD_CPU_RTOL``, params within ``PAPER_PARAM_ATOL``), then from the
    CPU's trained net on both devices fp logits (``PAPER_LOGIT_RTOL``),
    and int8 and the exact encoding (calibrated, the encoding's position
    weights fine-tuned) with identical predictions or splits located at
    a .5 code."""
    import numpy as np
    import torch
    from repro_torch.apps import image_cls as ic
    from repro_torch.apps.paper import cnn_data, prepare
    from repro_torch.core.layers import MacConfig
    from repro_torch.models import to_device
    n, n_train, epochs, ft = PAPER_REDUCED
    data = cnn_data(n, n_train)
    p0 = _cnn_numpy_init()
    fp = MacConfig(mode="fp")
    losses, trained = {}, {}
    for where, d in (("cpu", "cpu"), ("cuda", dev)):
        losses[where] = []
        trained[where] = ic.train_cnn(ic.params_from_jax(p0, d), data[0],
                                      data[1], fp, epochs=epochs,
                                      losses=losses[where])
    lc = [float(x) for x in losses["cpu"]]
    lg = [float(x) for x in losses["cuda"]]
    rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    perr = max((trained["cpu"][k]["w"] - trained["cuda"][k]["w"].cpu())
               .abs().max().item() for k in PAPER_LAYERS)
    log(f"[paper] reduced fp training ({n_train} images, {len(lc)} steps) "
        f"CPU/card losses {[f'{a:.6f}/{b:.6f}' for a, b in zip(lc, lg)]}: "
        f"worst rel {rel:.2e} (gate {CARD_CPU_RTOL}), params apart by "
        f"{perr:.2e} (gate {PAPER_PARAM_ATOL})")
    if rel > CARD_CPU_RTOL or perr > PAPER_PARAM_ATOL:
        raise AssertionError("paper: card and CPU training part")
    pc = trained["cpu"]
    pg = to_device(pc, dev)
    vi = data[2]
    with torch.no_grad():
        lcpu = ic.cnn_apply(pc, torch.from_numpy(vi), fp)
        lgpu = ic.cnn_apply(pg, torch.from_numpy(vi).to(dev), fp).cpu()
    lerr = ((lcpu - lgpu).abs().max() / lcpu.abs().max()).item()
    log(f"[paper] fp logits card vs CPU: {lerr:.2e} of max|logit| (gate "
        f"{PAPER_LOGIT_RTOL})")
    if lerr > PAPER_LOGIT_RTOL:
        raise AssertionError(f"paper: fp logits part card vs CPU ({lerr})")
    out = {"train_loss_rel": rel, "param_apart": perr, "logit_rel": lerr}
    for tag, mode, mac, steps in (("int8", "int8", None, 0),
                                  ("exact", "encoded", exact, ft)):
        prep = {}
        for where, p in (("cpu", pc), ("cuda", pg)):
            prep[where], mcfg = prepare(p, mode, mac, data,
                                        finetune_steps=steps)
        preds = {w: ic.predict(q, vi, mcfg) for w, q in prep.items()}
        scale_rel = max(abs(float(prep["cpu"][k]["a_scale"])
                            - float(prep["cuda"][k]["a_scale"]))
                        / float(prep["cpu"][k]["a_scale"])
                        for k in PAPER_LAYERS)
        apart = np.flatnonzero(preds["cpu"] != preds["cuda"])
        log(f"[paper] {tag}: scales card vs CPU within {scale_rel:.2e}; "
            f"predictions on {len(vi)} images: {len(apart)} apart; "
            f"accuracy CPU {np.mean(preds['cpu'] == data[3]):.4f} card "
            f"{np.mean(preds['cuda'] == data[3]):.4f}")
        for i in apart:
            with torch.no_grad():
                lg_i = ic.cnn_apply(prep["cpu"], torch.from_numpy(
                    vi[i:i + 1]), mcfg)[0]
            _paper_split_origin(prep["cpu"], prep["cuda"], mcfg,
                                vi[i:i + 1], lg_i)
        out[tag] = {"apart": int(len(apart)), "scale_rel": scale_rel}
    return out


def phase_paper(dev):
    """Phase 10: the paper's side (see the module docstring)."""
    import torch
    from repro_torch.apps import paper
    from repro_torch.core.mac import EncodedMac
    from repro_torch.hw import table1
    from repro_torch.serve import exact_encodings
    t_start = time.perf_counter()
    exact = exact_encodings(8, ("w",))["w"]
    _reset_counts()
    res = {"card_cpu": _paper_card_cpu(dev, exact)}
    # (b) Table 2 in full on the card, and the exact encoding on its net
    t0 = time.perf_counter()
    mac = EncodedMac.default(device=dev)
    data = paper.cnn_data()
    params = paper.train_fp(data, dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t2 = paper.table2_rows(params, mac, data)
    acc_exact = paper.eval_mode(params, "encoded", exact, data)
    t_table2 = time.perf_counter() - t0
    for line in paper.table2.csv_lines(t2):
        log(f"[paper] {line}")
    fp_acc, int8_acc = t2["fp32"], t2["uniform8"]["orig"]
    log(f"[paper] table2 on the card ({t_table2:.1f}s, training "
        f"{t_train:.1f}s): {json.dumps(t2)}; exact encoding {acc_exact:.4f}"
        f" (gates: fp >= {PAPER_FP_MIN}, int8 within {PAPER_INT8_TOL} of "
        f"fp, exact within {PAPER_EXACT_TOL} of int8; default-encoding rows "
        f"logged, not gated) ({SMI})")
    if fp_acc < PAPER_FP_MIN or abs(int8_acc - fp_acc) > PAPER_INT8_TOL \
            or abs(acc_exact - int8_acc) > PAPER_EXACT_TOL:
        raise AssertionError(f"paper: Table 2 gates fail: fp {fp_acc}, "
                             f"int8 {int8_acc}, exact {acc_exact}")
    res["table2"] = dict(t2, exact=acc_exact, seconds=t_table2)
    # (c) Table 1 within 0.05 of the paper; the simulator equals both
    # closed forms (``paper.latency.run`` raises where it does not)
    for r in table1():
        if abs(r["area_red"] - r["paper_area_red"]) >= 0.05 or \
                abs(r["power_red"] - r["paper_power_red"]) >= 0.05:
            raise AssertionError(f"paper: Table 1 row N={r['N']} is 0.05 "
                                 "or more from the paper")
    for drv, kw in ((paper.table1, {}), (paper.latency, {}),
                    (paper.fig7, {}), (paper.fig5, {"widths": (48,)}),
                    (paper.fig6, {"widths": (48,)})):
        t0 = time.perf_counter()
        out = drv.run(device=dev, **kw)
        secs = time.perf_counter() - t0
        for line in drv.csv_lines(out):
            log(f"[paper] {line}")
        log(f"[paper] {drv.name}{' at width 48' if kw else ''}: {secs:.1f}s")
        res[drv.name] = {"seconds": secs}
        if drv is paper.fig7:
            res[drv.name].update(width=out["task_specific_width"],
                                 rmse=out["found_rmse"])
        elif drv is paper.fig5:
            res[drv.name].update(out["per_width"]["48"])
        elif drv is paper.fig6:
            res[drv.name].update(
                random_10k=out["rmse_random_10k"],
                anneal_3k=out["rmse_anneal_3k"],
                width_48=out["rmse_vs_width"]["48"],
                found_width=out["binary_search"]["found_width"])
    busy = {k: v for k, v in _read_counts().items() if v}
    if busy:
        raise AssertionError(f"paper: the conv-net path launched kernels: "
                             f"{busy}")
    res["seconds"] = time.perf_counter() - t_start
    print(json.dumps({"paper": res}, default=float), flush=True)
    torch.cuda.empty_cache()
    return res


def _phase(fn, *args):
    """Run one phase and log its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"[phase] {fn.__name__} in {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    t_start = time.perf_counter()
    dev = card_check()
    import torch
    # keep each engine graph's node list for ``graph_kernel_counts``
    from repro_torch.serve.graphs import Step
    Step.keep_graph = True
    _phase(phase_build)
    _phase(phase_kernel1, dev)
    _phase(phase_kernel1_archs, dev)
    _phase(phase_kernel1_moe, dev)
    _phase(phase_kernel1_new, dev)
    _phase(phase_kernel1_xlstm, dev)
    _phase(phase_kernel1_tp, dev)
    _phase(phase_kernel2, dev)
    _phase(phase_kernel2_quant, dev)
    _phase(phase_kernel2_d128, dev)
    _phase(phase_kernel2_tp, dev)
    _phase(phase_flash, dev)
    serve_info = _phase(phase_serve, dev)
    serve_info.update(_phase(phase_serve_quant, dev, serve_info))
    serve_info["prefix"] = _phase(phase_prefix, dev, serve_info)
    serve_info["spec"] = _phase(phase_spec, dev, serve_info)
    serve_info["telemetry"] = _phase(phase_telemetry, dev, serve_info)
    serve_info["static"] = _phase(phase_static, dev, serve_info)
    # phase 6k's single-rank eager baselines (each gated equal to its
    # graphed serve, and spec decoding's to plain decode)
    serve_info["tp_base"] = {
        "bf16": serve_info["tokens"],
        "int8": serve_info["int8"]["tokens"],
        "int4": serve_info["int4"]["tokens"],
        "prefix": serve_info["prefix"]["tokens"],
        "static": serve_info["static"]["tokens"],
        "eager_tok_s": {"bf16": serve_info["eager_tok_s"],
                        "int8": serve_info["int8"]["eager_tok_s"],
                        "int4": serve_info["int4"]["eager_tok_s"],
                        "static": serve_info["static"]["eager_tok_s"]}}
    for key in ("params", "cfg", "params_enc", "cfg_enc", "trace", "tokens",
                "stats"):
        del serve_info[key]
    torch.cuda.empty_cache()
    serve_info["search"] = _phase(phase_serve_search, dev)
    serve_info["archs"] = _phase(phase_archs, dev)
    serve_info["moe"] = _phase(phase_moe, dev)
    serve_info["new"] = _phase(phase_new_archs, dev)
    serve_info["xw"] = _phase(phase_xlstm_whisper, dev)
    serve_info["tp_base"]["moe"] = serve_info["moe"][
        "qwen3-moe-235b-a22b"].pop("eager")
    serve_info["tp"] = _phase(phase_tp, dev, serve_info)
    shutil.rmtree(serve_info.pop("bundle"))
    started = _phase(phase_cli_start, dev)
    try:
        _phase(phase_cpu_parity, dev)
        _phase(phase_cpu_parity_archs, dev)
        _phase(phase_cpu_parity_moe, dev)
        _phase(phase_cpu_parity_new, dev)
        _phase(phase_cpu_parity_xw, dev)
        _phase(phase_cli_int8, dev)
        _phase(phase_cli_mesh, dev, started)
        _phase(phase_cli_train_mesh, dev, started)
        _phase(phase_cli_train_full, dev, started)
    finally:
        for key in ("serve", "train", "train_full"):
            if started[key][0].poll() is None:
                started[key][0].kill()
                started[key][0].wait()
        shutil.rmtree(started["tmp"], ignore_errors=True)
    _phase(phase_cpu_parity_search, dev)
    _phase(phase_train, dev)
    _phase(phase_paper, dev)
    rows = _phase(phase_measure, dev, serve_info)
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
