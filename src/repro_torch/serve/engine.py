"""Continuous-batching greedy ``Engine`` over the paged KV cache (port of
``Engine`` from ``repro/serve/engine.py``, with its prefix cache,
speculative decoding, telemetry and allocator sanitizer), and the
static-batch ``ServeEngine`` with ``generate`` over the dense KV cache,
the reference's baseline and the serving CLI's default.

Both engines and ``generate`` take ``mesh=`` (``parallel.mesh.Mesh``,
``D x M``) for serving over several ranks, one engine per rank process
(the static engine and ``generate``: the dense, moe, vlm and encdec
families, MLA included; the continuous engine: those that page): each
rank keeps
its model-axis slices of the params (``parallel.sharding.shard_params``;
the data axis replicates them), its pools and dense caches hold its kv
heads, and every step runs under the mesh.  The data axis follows the
reference's placement (``parallel.statesharding.SERVING_CACHE``): one
scheduler, allocator and prefix index on every rank, the paged pools
whole on every data row, a batch the data axis divides split into
contiguous rows (a decode, draft or verify step's slots, a static
chunk's requests) and any other batch, every B = 1 prefill chunk among
them, run whole on every row.  A split step's tokens are put together by
one all-gather over the data axis, so every rank's host-side scheduler
makes the same decisions from the same tokens.  Steps under a mesh run
eagerly: gloo's collectives cannot be captured in a CUDA graph.

A scheduler admits queued requests into a fixed number of slots under a
page budget; each engine step runs one prefill chunk per prefilling slot
(``(1, prefill_chunk)`` tokens, right-padded) and then one decode step for
all ``n_slots`` rows, whatever each request's progress (or, with
``spec_decode=k``, one draft + verify round).  The page pools are updated
in place by every step.

Every step the reference jits runs here as one captured CUDA graph on the
card (``serve/graphs.py``): the prefill chunk, the decode step, the k
unrolled draft steps and the verify forward, one graph per shape; the
static engine's decode step likewise, one graph per (batch, max_len)
(its prefill stays eager, as the reference jits it per prompt shape).
"""
from __future__ import annotations

import collections
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.analysis.ledger import sanitize_enabled
from repro_torch.core.macexec import check_drafter, debug_nan_enabled
from repro_torch.device import resolve_device
from repro_torch.models import (apply_model, init_cache, reset_cache,
                                supports_paged_cache, supports_ragged_mask)
from repro_torch.models.lm import STATE_KEYS, paged_cache_layout
from repro_torch.obs import CompileTracker, percentile, profiler_trace
from repro_torch.parallel.mesh import (AXIS_DATA, batch_replicated,
                                       get_mesh, replicated_batch, set_mesh)
from repro_torch.parallel.sharding import replicated_parts, shard_params
from repro_torch.parallel.statesharding import cache_rows
from repro_torch.tree import tree_leaves
from .graphs import Step
from .paged_cache import PagedKVCache
from .scheduler import DECODING, FINISHED, Request, Scheduler
from .spec import greedy_accept, make_spec_draft, make_spec_verify
from .telemetry import TID_DEVICE, TID_ENGINE, ServeTelemetry, req_tid


def _graphs_on(device: torch.device, cuda_graphs: Optional[bool],
               mesh=None) -> bool:
    """An engine's ``cuda_graphs``: None = on the card only, and not
    while ``set_debug_nan`` is on (a graph replay cannot stop at the first
    non-finite output) or under a mesh (gloo's collectives cannot be
    captured); True on the CPU, under ``set_debug_nan`` or under a mesh
    raises."""
    if mesh is not None and cuda_graphs:
        raise ValueError("cuda_graphs=True under a mesh: gloo's collectives "
                         "cannot be captured in a CUDA graph (graph-captured "
                         "tensor-parallel steps need NCCL on several cards, "
                         "ROADMAP Queue A, item 4)")
    if cuda_graphs is None:
        return (device.type == "cuda" and not debug_nan_enabled()
                and mesh is None)
    if cuda_graphs and device.type != "cuda":
        raise ValueError("cuda_graphs=True needs the card; the engine runs "
                         f"on {device}")
    if cuda_graphs and debug_nan_enabled():
        raise ValueError("cuda_graphs=True under set_debug_nan: a graph "
                         "replay cannot stop at the first non-finite output")
    return bool(cuda_graphs)


def _meshed(mesh, fn, replicated: bool = False):
    """``fn`` run under ``mesh`` (the model code reads the active mesh),
    its batch marked whole on every data row where ``replicated``; ``fn``
    itself without a mesh."""
    if mesh is None:
        return fn

    def run(*args, **kw):
        with set_mesh(mesh), replicated_batch(replicated):
            return fn(*args, **kw)
    return run


def _gather_rows(mesh, t: torch.Tensor, split: bool) -> torch.Tensor:
    """A split step's rows ``t`` (host tensor) of every data row, stacked
    in row order (one all-gather over the data axis); ``t`` as it is
    where the step ran every row."""
    return mesh.all_gather(t, AXIS_DATA) if split else t


def _mesh_stats(mesh, cfg, split: bool = False) -> dict:
    """``mesh``: the axes (None without a mesh), as the reference's;
    ``mesh_replicated``: the parts of a block that run replicated;
    ``data_split``: whether the batched steps ran each data row's rows
    (False where the data axis does not divide the batch, or is 1)."""
    if mesh is None:
        return {"mesh": None, "mesh_replicated": [], "data_split": False}
    return {"mesh": dict(mesh.shape),
            "mesh_replicated": replicated_parts(cfg, mesh),
            "data_split": split}


def make_paged_prefill(cfg):
    """Prefill one right-padded token chunk (1, C) into its pages from
    offset ``lens`` (0 for a fresh slot; the cached tokens for a later
    chunk or after a prefix-cache hit).  Returns the greedy token at every
    position (1, C) int32; the pools are written in place."""
    def prefill(params, layers, tokens, pages, lens):
        cache = {"layers": layers, "pages": pages, "lens": lens}
        logits, _ = apply_model(params, cfg, tokens, cache=cache)
        return torch.argmax(logits[..., :cfg.vocab_size],
                            dim=-1).to(torch.int32)
    return prefill


def make_paged_decode_step(cfg):
    """One greedy token (B,) int32 for every slot against the shared page
    pools."""
    def step(params, layers, tokens, pages, lens):
        cache = {"layers": layers, "pages": pages, "lens": lens}
        logits, _ = apply_model(params, cfg, tokens, cache=cache)
        return torch.argmax(logits[:, -1, :cfg.vocab_size],
                            dim=-1).to(torch.int32)
    return step


class Engine:
    """Continuous-batching greedy serving engine over the paged KV cache.

    ``reserve='conservative'`` admits a request only when pages for
    prompt+max_new are free; ``'optimistic'`` admits on prompt pages alone
    and grows page by page, evicting the youngest running request on
    exhaustion (its generated tokens are kept and re-prefilled).

    ``prefix_cache=True``: full prompt pages are hash-indexed after
    prefill, and admission maps matching cached pages into a new request's
    table (refcount-shared, copied on write), so only the uncached suffix
    is prefilled.

    ``spec_decode=k`` (k >= 1): each decode round drafts k greedy tokens
    per slot with ``draft_params``/``draft_cfg`` (default: the serving
    params) in one step, verifies all k+1 positions in one batched forward
    over the same pools and commits the longest agreeing prefix plus a
    bonus token.  Greedy output is token-identical to ``spec_decode=0``
    for any drafter; build a cheap one with
    ``repro_torch.serve.encoded.prepare_drafter``.

    On the moe family each MoE call sizes its expert capacity from its own
    padded B·S, as in the reference: a prefill of only the uncached
    suffix, a draft step and a verify forward route other batches than a
    plain serve's calls, so where capacity drops pairs the tokens may part
    from ``prefix_cache=False`` / ``spec_decode=0`` (they stay the
    reference engine's).

    ``telemetry``: a ``ServeTelemetry`` (default: metrics only).  Its
    registry holds the engine's and scheduler's bookkeeping, which
    ``stats()`` and the read-only ``metrics`` view read back; with
    ``trace=True`` every step, prefill chunk, decode step, draft and
    verify is a span on the engine track and every request's lifecycle a
    track of its own; with ``time_device=True`` the engine waits for the
    card after each step's replay (``device:*`` spans, ``device_*_ms``
    histograms); a ``DriftMonitor`` samples dense-vs-encoded agreement
    every N steps, or, under spec decoding, reads it from verification;
    ``profile_dir`` runs ``run()`` under ``torch.profiler``.

    ``sanitize``: attach the shadow page ledger to the pool (every
    allocator transition checked, page conservation verified after every
    step); None reads ``REPRO_SANITIZE``.

    ``cuda_graphs``: None (default) captures every step into a CUDA graph
    when the engine runs on the card (eagerly while ``set_debug_nan`` is
    on); False runs the same step functions eagerly; True on the CPU
    raises.  ``stats()["jit_compiles"]`` counts the graphs this engine
    captured (each after one eager warm-up run of its step, whose kernel
    launches count as any other).

    ``device`` defaults to the card; pass ``device="cpu"`` for the plain
    PyTorch versions.  ``params`` must already live on that device.

    ``mesh``: serve as one rank of it (``params`` and ``draft_params``
    whole; the engine keeps this rank's slices).  Every rank runs every
    prefill chunk (B = 1, replicated over data), so every prompt page is
    the same on every data row; where the data axis divides ``n_slots``,
    slot ``s`` belongs to data row ``s // (n_slots / D)``, whose decode,
    draft and verify steps run its slots' rows alone and write only their
    K/V, and one all-gather a step (a round under spec decoding) gives
    every rank the tokens.  Otherwise every row runs every slot and
    nothing is gathered.  ``stats()["mesh"]`` gives the axes,
    ``stats()["data_split"]`` which case ran,
    ``stats()["mesh_replicated"]`` the parts of a block whose dims do not
    divide the model axis."""

    def __init__(self, params, cfg, *, n_slots: int = 4,
                 page_size: int = 16, n_pages: int = 128,
                 max_seq_pages: Optional[int] = None,
                 reserve: str = "conservative", prefill_chunk: int = 32,
                 prefix_cache: bool = False,
                 telemetry: Optional[ServeTelemetry] = None,
                 spec_decode: int = 0, draft_params=None, draft_cfg=None,
                 sanitize: Optional[bool] = None, device=None,
                 cuda_graphs: Optional[bool] = None, mesh=None):
        if not supports_paged_cache(cfg):
            raise ValueError(f"{cfg.arch!r} cannot serve paged")
        if prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.mesh = mesh
        if mesh is not None:
            if telemetry is not None and telemetry.drift is not None:
                raise ValueError("the drift monitor runs the whole model "
                                 "on one rank; it is not ported under a "
                                 "mesh")
            params = shard_params(params, cfg, mesh)
            if draft_params is not None:
                draft_params = shard_params(
                    draft_params, draft_cfg if draft_cfg is not None
                    else cfg, mesh)
        self.params, self.cfg = params, cfg
        self.prefill_chunk = prefill_chunk
        self.tel = telemetry if telemetry is not None else \
            ServeTelemetry.disabled()
        if max_seq_pages is None:
            # default: one sequence may hold up to half the pool
            max_seq_pages = max(4, (n_pages - 1) // 2)
        if sanitize is None:
            # opt-in shadow page ledger: an env var, so a test suite can
            # sanitize every engine without touching call sites
            sanitize = sanitize_enabled()
        # the pools hold every page on every data row (and this rank's
        # kv heads); a data row's slots are its rows of the page table
        lo, hi = cache_rows("pool_k", n_pages, mesh)
        with set_mesh(mesh):
            self.kv = PagedKVCache(cfg, n_slots, hi - lo, page_size,
                                   max_seq_pages, device=device,
                                   sanitize=sanitize)
        self.rows = cache_rows("k", n_slots, mesh)
        self.split = self.rows != (0, n_slots)
        self.device = self.kv.device
        self.cuda_graphs = _graphs_on(self.device, cuda_graphs, mesh)
        self.sched = Scheduler(self.kv, reserve=reserve,
                               prefix_cache=prefix_cache, telemetry=self.tel)
        self.spec_k = int(spec_decode)
        if self.spec_k < 0:
            raise ValueError("spec_decode must be >= 0")
        def step(name, fn, replicated=not self.split):
            return Step(name, _meshed(mesh, fn, replicated),
                        device=self.device, graphs=self.cuda_graphs)
        # the step functions by name, each one graph per engine on the card
        self.steps = {
            "prefill": step("prefill", functools.partial(
                make_paged_prefill(cfg), params, self.kv.layers), True),
            "decode": step("decode", functools.partial(
                make_paged_decode_step(cfg), params, self.kv.layers))}
        if self.spec_k:
            self.draft_cfg = draft_cfg if draft_cfg is not None else cfg
            self.draft_params = (draft_params if draft_params is not None
                                 else params)
            check_drafter(self.draft_params, self.draft_cfg.mac.mode)
            # the drafter writes into the verifier's pools, so its paged
            # cache geometry must match exactly
            with set_mesh(mesh):
                mismatch = (paged_cache_layout(self.draft_cfg, 2, page_size)
                            != paged_cache_layout(cfg, 2, page_size))
            if mismatch:
                raise ValueError(
                    "spec_decode drafter cache geometry mismatch: "
                    "draft_cfg must produce the same paged KV layout "
                    "(layers/kv-heads/head-dim/dtype) as the serving cfg")
            self.steps["draft"] = step("draft", functools.partial(
                make_spec_draft(self.draft_cfg, self.spec_k),
                self.draft_params, self.kv.layers))
            self.steps["verify"] = step("verify", functools.partial(
                make_spec_verify(cfg, self.spec_k), params, self.kv.layers))
        # graph-capture accounting: deltas over each step's captures since
        # this engine attached (``copy_page`` is an eager copy: label 0)
        self.jit_tracker = CompileTracker()
        for name, st in self.steps.items():
            self.jit_tracker.track(name, st)
        self.requests = {}
        self._next_rid = 0
        self.clock = 0
        self.decode_steps = 0
        self._init_metrics()

    def _init_metrics(self) -> None:
        """Registry-backed engine bookkeeping: the reference's metric
        names, helps and buckets (``metrics`` is a read-only view)."""
        reg = self.tel.registry
        self._mac = self.cfg.mac.mode
        self._c_steps = reg.counter("engine_steps", "engine loop ticks")
        self._c_decode = reg.counter("decode_tokens",
                                     "tokens produced by decode steps")
        self._c_prefill_tok = reg.counter("prefill_tokens",
                                          "prompt tokens ingested")
        self._c_prefills = reg.counter("prefills", "completed prefills")
        self._c_chunks = reg.counter("prefill_chunks",
                                     "prefill chunk dispatches")
        self._c_occ = reg.counter("occupancy_sum",
                                  "per-step busy-slot fraction, summed")
        self._c_stalls = reg.counter(
            "stalls", "decode steps a request sat page-starved")
        self._c_rejects = reg.counter("rejects",
                                      "requests rejected at submit")
        self._c_jit = reg.counter(
            "jit_compiles",
            "CUDA-graph captures of the serving steps since this engine "
            "attached (labeled fn=prefill|decode|draft|verify|copy_page)")
        self._h_step = reg.histogram("step_ms", "engine step wall ms",
                                     buckets=(1, 2, 5, 10, 25, 50, 100,
                                              250, 500, 1000))
        dev_buckets = (0.5, 1, 2, 5, 10, 25, 50, 100, 250, 500)
        self._h_dev_decode = reg.histogram(
            "device_decode_ms", "blocked decode-step device ms",
            buckets=dev_buckets)
        self._h_dev_prefill = reg.histogram(
            "device_prefill_ms", "blocked prefill-chunk device ms",
            buckets=dev_buckets)
        self._g_pages_free = reg.gauge("pages_free",
                                       "strictly free pool pages")
        self._g_pages_cached = reg.gauge(
            "pages_cached", "ref-0 pages parked in the prefix LRU tier")
        self._g_pages_held = reg.gauge("pages_held",
                                       "pages referenced by sequences")
        self._g_queue = reg.gauge("queue_depth", "requests waiting")
        self._g_hit_win = reg.gauge(
            "prefix_windowed_hit_rate",
            "prefix-cache hit rate over recent admissions")
        self._g_kv_bpt = reg.gauge(
            "kv_bytes_per_token",
            "pool bytes per cached token across layers (values + scales)")
        self._g_kv_cap = reg.gauge(
            "kv_capacity_tokens",
            "token capacity of the allocatable page pool")
        self._g_kv_bpt.set(self.kv.kv_bytes_per_token())
        self._g_kv_cap.set((self.kv.n_pages - 1) * self.kv.page_size)
        self._c_spec_rounds = reg.counter(
            "spec_rounds", "speculative draft+verify rounds")
        self._c_spec_prop = reg.counter(
            "spec_draft_tokens", "draft tokens considered by verification")
        self._c_spec_acc = reg.counter(
            "spec_accepted_tokens", "draft tokens accepted by verification")
        self._g_spec_rate = reg.gauge(
            "spec_acceptance_rate",
            "accepted / considered draft tokens, cumulative")
        self._h_dev_draft = reg.histogram(
            "device_draft_ms", "blocked draft-k device ms",
            buckets=dev_buckets)
        self._h_dev_verify = reg.histogram(
            "device_verify_ms", "blocked verify-step device ms",
            buckets=dev_buckets)

    @property
    def metrics(self) -> dict:
        """Read-only snapshot with the reference's key set (the engine
        itself increments registry metrics, not this dict)."""
        return {
            "steps": int(self._c_steps.total()),
            "decode_tokens": int(self._c_decode.total()),
            "prefill_tokens": int(self._c_prefill_tok.total()),
            "prefills": int(self._c_prefills.total()),
            "prefill_chunks": int(self._c_chunks.total()),
            "occupancy_sum": self._c_occ.total(),
        }

    @property
    def step_ms(self) -> list:
        """Every step's wall ms so far, in order (the ``step_ms``
        histogram's samples)."""
        return self._h_step.samples(mac=self._mac)

    @property
    def _steps(self) -> int:
        return int(self._c_steps.total())

    def _sync(self) -> None:
        """``time_device``: wait for the card (a graph replay returns
        before its kernels finish); the CPU computes synchronously."""
        if self.device.type == "cuda":
            # analysis: allow(host-sync): opt-in time_device wait
            torch.cuda.synchronize(self.device)

    # ---- API ---------------------------------------------------------------

    def submit(self, prompt, max_new: int = 32,
               eos_id: Optional[int] = None) -> int:
        prompt = np.asarray(prompt, np.int32).ravel()
        tr = self.tel.tracer
        if int(prompt.shape[0]) + max_new > self.kv.max_seq_tokens:
            # reject before registering: a raise after registration would
            # leak a dead rid into self.requests
            self._c_rejects.inc()
            if tr.enabled:
                tr.instant("reject", tid=TID_ENGINE, cat="lifecycle",
                           args={"plen": int(prompt.shape[0]),
                                 "max_new": max_new,
                                 "limit": self.kv.max_seq_tokens})
            raise ValueError(
                f"request of {prompt.shape[0]} prompt + {max_new} new "
                f"tokens exceeds the {self.kv.max_seq_tokens}-token "
                f"per-sequence limit (max_seq_pages={self.kv.max_seq_pages}"
                f" × page_size={self.kv.page_size}); raise max_seq_pages "
                "or split the request")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new=max_new, eos_id=eos_id,
                      t_arrive=time.perf_counter())
        self.requests[rid] = req
        self.sched.submit(req)
        if tr.enabled:
            tr.thread(req_tid(rid), f"req {rid}")
            tr.instant("submit", tid=req_tid(rid), cat="lifecycle",
                       args={"rid": rid, "plen": int(prompt.shape[0]),
                             "max_new": max_new}, t_s=req.t_arrive)
        return rid

    @property
    def busy(self) -> bool:
        return self.sched.busy

    def run(self, max_steps: int = 100_000) -> dict:
        """Drive the loop until the queue and all slots drain; at most
        ``max_steps`` steps in this call.  With ``telemetry.profile_dir``
        set, the drain runs under a ``torch.profiler`` trace."""
        start = self._steps
        with profiler_trace(self.tel.profile_dir):
            while self.busy:
                if self._steps - start >= max_steps:
                    raise RuntimeError(f"engine did not drain within "
                                       f"{max_steps} steps (livelock?)")
                self.step()
        return self.results()

    def results(self) -> dict:
        # analysis: allow(host-sync): r.out is a host list of ints
        return {rid: np.asarray(r.out, np.int32)
                for rid, r in self.requests.items() if r.state == FINISHED}

    def step(self) -> None:
        """One scheduler tick, instrumented: a span on the engine track,
        its wall time in the ``step_ms`` histogram, the allocator and
        queue gauges refreshed after the work and, with the sanitizer,
        page conservation verified."""
        tr = self.tel.tracer
        t0 = time.perf_counter()
        try:
            self._step_impl()
        finally:
            t1 = time.perf_counter()
            self._h_step.observe((t1 - t0) * 1e3, mac=self._mac)
            if tr.enabled:
                tr.complete("step", t0, t1, tid=TID_ENGINE, cat="engine",
                            args={"step": self._steps})
            self._update_gauges()
            if self.kv.ledger is not None:
                self.kv.ledger.verify()

    def _update_gauges(self) -> None:
        """Pool / queue / prefix gauges (free–held–cached page split)."""
        al = self.kv.alloc
        self._g_pages_free.set(al.n_free_strict)
        self._g_pages_cached.set(al.n_cached)
        self._g_pages_held.set(al.n_held)
        self._g_queue.set(len(self.sched.queue))
        if self.sched.prefix is not None:
            self._g_hit_win.set(self.sched.prefix.windowed_hit_rate)

    # ---- one scheduler tick ------------------------------------------------

    def _step_impl(self) -> None:
        self._c_steps.inc()
        self.clock += 1
        if self.tel.drift is not None and not self.spec_k:
            # under spec decoding drift comes from verification
            # (observe_agreement in _spec_round): no extra forward
            self.tel.drift.maybe_sample(
                self._steps, self.params, self.cfg,
                [r.prompt for r in self.sched.slots if r is not None])
        # admit and run ONE prefill chunk per prefilling slot; a prefill
        # that finishes at EOS frees its slot, so keep admitting until no
        # new slot fills (each request still runs at most one chunk)
        chunked = set()
        while True:
            self.sched.admissions()
            todo = [r for r in self.sched.prefilling()
                    if r.rid not in chunked]
            if not todo:
                break
            for req in todo:
                chunked.add(req.rid)
                self._prefill_chunk(req)
        if self.spec_k:
            self._spec_round(chunked)
            return
        active = self._runnable()
        worked = set(chunked) | {r.rid for r in active}
        self._c_occ.inc(len(worked) / self.kv.n_slots)
        if not active:
            self._check_progress(chunked)
            return
        tokens = np.zeros((self.kv.n_slots, 1), np.int32)
        # refresh lens for every slotted request (stalled ones included, so
        # their dummy write this step lands past their pages → scratch;
        # mid-prefill slots' dummy write lands at their cursor and is
        # overwritten by their next chunk before it is ever read); idle
        # rows keep lens 0 and an all-scratch page row
        for r in self.sched.slots:
            if r is not None:
                self.kv.set_len(r.slot, r.n_cached)
        for req in active:
            tokens[req.slot, 0] = req.out[-1]
        tr = self.tel.tracer
        lo, hi = self.rows
        t_d0 = time.perf_counter()
        out = self.steps["decode"](tokens[lo:hi], *self.kv.rows_view(lo, hi))
        if self.tel.time_device:
            self._sync()
            t_d1 = time.perf_counter()
            self._h_dev_decode.observe((t_d1 - t_d0) * 1e3, mac=self._mac)
            if tr.enabled:
                tr.complete("device:decode", t_d0, t_d1, tid=TID_DEVICE,
                            cat="device", args={"n_active": len(active)})
        # analysis: allow(host-sync): the step boundary, tokens to host
        toks = _gather_rows(self.mesh, out.cpu(), self.split)
        # analysis: allow(host-sync): the gathered tokens, a host tensor
        toks = toks.numpy()
        if tr.enabled:
            tr.complete("decode_step", t_d0, time.perf_counter(),
                        tid=TID_ENGINE, cat="engine",
                        args={"n_active": len(active),
                              "rids": [r.rid for r in active]})
        self.decode_steps += 1
        now = time.perf_counter()
        for req in active:
            req.n_cached += 1
            req.out.append(int(toks[req.slot]))
            self._c_decode.inc(1, mac=self._mac)
            if req.done:
                self.sched.finish(req, now)
                self._trace_finish(req)

    def _check_progress(self, chunked) -> None:
        """No request decodes this step: fine while prefill progresses or
        nothing waits; a queued request that no pool could hold raises."""
        if chunked or not self.sched.queue:
            return
        raise RuntimeError(
            "page pool too small for the queued request "
            f"(need {self.sched._pages_needed(self.sched.queue[0])}"
            f" pages, {self.kv.alloc.n_free} free)")

    def _spec_round(self, chunked) -> None:
        """One speculative draft + verify round (the reference's
        ``Engine._spec_round``).

        Each active slot secures a write window of ``min(k+1, tokens
        left)`` positions it owns alone (``ensure_write_window``; on
        failure a window of 1, else it stalls); the drafter drafts k
        tokens (one step), the verifier scores the k+1 positions (one
        step, reading the draft on the device) and the longest agreeing
        prefix plus the bonus token is committed, capped at the window:
        logits past it may have read scratch.  Rejected positions are
        rolled back by host arithmetic on ``n_cached``.  Slotted requests
        that do not decode get lens at the end of their own pages, so the
        round's k+1 writes land in the scratch page."""
        k = self.spec_k
        tr = self.tel.tracer
        active, wins = [], {}
        for req in sorted(self.sched.active(),
                          key=lambda r: (r.t_arrive, r.rid)):
            if req.state != DECODING:
                continue                    # evicted mid-loop by a peer
            want = min(k + 1, req.max_new - len(req.out))
            if self.sched.ensure_write_window(req, want):
                wins[req.rid] = want
            elif want > 1 and self.sched.ensure_write_window(req, 1):
                wins[req.rid] = 1
            else:
                self._c_stalls.inc()
                if tr.enabled:
                    tr.instant("stall", tid=req_tid(req.rid),
                               cat="lifecycle", args={"rid": req.rid})
                continue
            active.append(req)
        active = [r for r in active if r.state == DECODING]  # late evicts
        worked = set(chunked) | {r.rid for r in active}
        self._c_occ.inc(len(worked) / self.kv.n_slots)
        if not active:
            self._check_progress(chunked)
            return
        act = {r.rid for r in active}
        for r in self.sched.slots:
            if r is None:
                continue
            if r.rid in act:
                self.kv.set_len(r.slot, r.n_cached)
            else:
                self.kv.set_len(r.slot, len(r.pages) * self.kv.page_size)
        tokens = np.zeros((self.kv.n_slots, 1), np.int32)
        for req in active:
            tokens[req.slot, 0] = req.out[-1]
        draft, verify = self.steps["draft"], self.steps["verify"]
        lo, hi = self.rows
        t_d0 = time.perf_counter()
        d_toks = draft(tokens[lo:hi], *self.kv.rows_view(lo, hi))
        if self.tel.time_device:
            self._sync()
            t_d1 = time.perf_counter()
            self._h_dev_draft.observe((t_d1 - t_d0) * 1e3,
                                      mac=self.draft_cfg.mac.mode)
            if tr.enabled:
                tr.complete("device:draft", t_d0, t_d1, tid=TID_DEVICE,
                            cat="device", args={"k": k,
                                                "n_active": len(active)})
        if tr.enabled:
            tr.complete("draft_step", t_d0, time.perf_counter(),
                        tid=TID_ENGINE, cat="engine",
                        args={"k": k, "rids": [r.rid for r in active]})
        # the draft stays on the device: verify reads it, the round's
        # input tokens, page table and lens from the draft step's own
        # tensors, so draft → verify needs no copy and no host sync
        t_v0 = time.perf_counter()
        v_toks = verify(draft.arg(0), d_toks, draft.arg(1), draft.arg(2))
        if self.tel.time_device:
            self._sync()
            t_v1 = time.perf_counter()
            self._h_dev_verify.observe((t_v1 - t_v0) * 1e3, mac=self._mac)
            if tr.enabled:
                tr.complete("device:verify", t_v0, t_v1, tid=TID_DEVICE,
                            cat="device", args={"k": k,
                                                "n_active": len(active)})
        # analysis: allow(host-sync): the round's end: acceptance reads
        # the draft and the verifier's tokens on the host
        d_np, v_np = d_toks.cpu().numpy(), v_toks.cpu().numpy()
        if tr.enabled:
            tr.complete("verify_step", t_v0, time.perf_counter(),
                        tid=TID_ENGINE, cat="engine",
                        args={"k": k, "rids": [r.rid for r in active]})
        # acceptance, on the data row that owns the slot: per row of the
        # step, [accepted, emitted, the emitted tokens]
        acc = np.zeros((hi - lo, k + 3), np.int32)
        for req in active:
            if not lo <= req.slot < hi:
                continue
            cons = min(k, wins[req.rid] - 1)   # draft tokens we may trust
            d, v = d_np[req.slot - lo], v_np[req.slot - lo]
            n_acc = greedy_accept(d[:cons], v[:cons])
            emit = [int(x) for x in d[:n_acc]] + [int(v[n_acc])]
            emit = emit[:req.max_new - len(req.out)]
            if req.eos_id is not None:
                for j, t in enumerate(emit):
                    if t == req.eos_id:
                        emit = emit[:j + 1]
                        break
            acc[req.slot - lo, :2] = n_acc, len(emit)
            acc[req.slot - lo, 2:2 + len(emit)] = emit
        # analysis: allow(host-sync): the rows' acceptance, a host tensor
        acc = _gather_rows(self.mesh, torch.from_numpy(acc),
                           self.split).numpy()
        now = time.perf_counter()
        r_acc = r_cons = 0
        for req in active:
            cons = min(k, wins[req.rid] - 1)
            n_acc, n_emit = int(acc[req.slot, 0]), int(acc[req.slot, 1])
            emit = [int(x) for x in acc[req.slot, 2:2 + n_emit]]
            req.out.extend(emit)
            req.n_cached += len(emit)
            self._c_decode.inc(len(emit), mac=self._mac)
            r_acc += n_acc
            r_cons += cons
            if req.done:
                self.sched.finish(req, now)
                self._trace_finish(req)
        self._c_spec_rounds.inc()
        self._c_spec_prop.inc(r_cons)
        self._c_spec_acc.inc(r_acc)
        prop, acc = self._c_spec_prop.total(), self._c_spec_acc.total()
        if prop:
            self._g_spec_rate.set(acc / prop)
        if self.tel.drift is not None:
            # drift for free: draft-vs-target top-1 agreement measured on
            # the verifier's logits, no extra forward
            self.tel.drift.observe_agreement(r_acc, r_cons)

    def _runnable(self):
        """Decoding requests with a page of their own for their next
        write, oldest first (growth may evict younger requests; a request
        that can neither grow nor evict stalls this step)."""
        out = []
        tr = self.tel.tracer
        for req in sorted(self.sched.active(),
                          key=lambda r: (r.t_arrive, r.rid)):
            if req.state != DECODING:
                continue                     # evicted by an older peer
            if self.sched.ensure_page(req):
                out.append(req)
            else:
                self._c_stalls.inc()
                if tr.enabled:
                    tr.instant("stall", tid=req_tid(req.rid),
                               cat="lifecycle", args={"rid": req.rid})
        return out

    def _prefill_chunk(self, req: Request) -> None:
        """Run one fixed-shape prefill chunk for a PREFILLING request from
        its cursor ``n_cached`` (past the mapped pages after a prefix-cache
        hit).  On the final chunk the request turns DECODING and its prompt
        pages enter the prefix index; a fresh request takes its first token
        from the last prompt position, a re-admitted one keeps the tokens
        it had."""
        stream = req.prefill_stream()
        target = req.prefill_target
        start = req.n_cached
        C = self.prefill_chunk
        chunk = stream[start:start + C]
        n = int(chunk.shape[0])
        padded = np.zeros((1, C), np.int32)
        padded[0, :n] = chunk
        tr = self.tel.tracer
        t_c0 = time.perf_counter()
        toks = self.steps["prefill"](
            padded, self.kv.ptab[req.slot:req.slot + 1],
            # analysis: allow(host-sync): a host int, no device data
            np.array([start], np.int32))
        if self.tel.time_device:
            self._sync()
            t_c1 = time.perf_counter()
            self._h_dev_prefill.observe((t_c1 - t_c0) * 1e3, mac=self._mac)
            if tr.enabled:
                tr.complete("device:prefill", t_c0, t_c1, tid=TID_DEVICE,
                            cat="device", args={"rid": req.rid, "n": n})
        if tr.enabled:
            tr.complete("prefill_chunk", t_c0, time.perf_counter(),
                        tid=TID_ENGINE, cat="engine",
                        args={"rid": req.rid, "start": start, "n": n})
        req.n_cached = start + n
        self.kv.set_len(req.slot, req.n_cached)
        self._c_chunks.inc(1, mac=self._mac)
        self._c_prefill_tok.inc(n, mac=self._mac)
        if req.n_cached < target:
            return
        now = time.perf_counter()
        req.state = DECODING
        req.t_prefill_done = now
        self._c_prefills.inc()
        self.sched.note_prefilled(req)
        if not req.out:
            # read before the next prefill replay overwrites the graph's
            # output
            # analysis: allow(host-sync): first-token read, once per
            # request
            req.out = [int(toks[0, req.plen - 1 - start])]
            if req.t_first is None:
                req.t_first = now
                if tr.enabled:
                    tr.instant("first_token", tid=req_tid(req.rid),
                               cat="lifecycle", args={"rid": req.rid},
                               t_s=now)
        if req.done:
            self.sched.finish(req, now)
            self._trace_finish(req)

    def _trace_finish(self, req: Request) -> None:
        """Emit the finished request's lifecycle phase spans on its own
        track: ``queued`` [submit → admit], ``prefill`` [admit → prefill
        done], ``decode`` [prefill done → finish], contiguous by
        construction, so their durations sum to the request latency (after
        an eviction ``queued`` absorbs the earlier rounds)."""
        tr = self.tel.tracer
        if not tr.enabled or req.t_finish is None:
            return
        tid = req_tid(req.rid)
        t_admit = req.t_admit if req.t_admit is not None else req.t_arrive
        t_pf = req.t_prefill_done if req.t_prefill_done is not None \
            else t_admit
        args = {"rid": req.rid, "n_out": len(req.out),
                "evictions": req.n_evictions}
        tr.complete("request", req.t_arrive, req.t_finish, tid=tid,
                    cat="lifecycle", args=args)
        tr.complete("queued", req.t_arrive, t_admit, tid=tid, cat="phase")
        tr.complete("prefill", t_admit, t_pf, tid=tid, cat="phase")
        tr.complete("decode", t_pf, req.t_finish, tid=tid, cat="phase")

    # ---- reporting ---------------------------------------------------------

    def stats(self) -> dict:
        """The registry's view plus request-derived percentiles, with the
        reference's keys (``mesh``: the axes, None without a mesh) and the
        port's own: ``admissions``, ``decode_steps``,
        ``attention_backend``, ``device``, ``cuda_graphs``,
        ``jit_compiles_by_step`` and ``mesh_replicated``.  Latency and
        TPOT are over finished requests, TTFT over every request with a
        first token, in-flight ones included; step percentiles come from
        the ``step_ms`` histogram."""
        reqs = list(self.requests.values())
        fin = [r for r in reqs if r.state == FINISHED]
        lat = [r.t_finish - r.t_arrive for r in fin
               if r.t_finish is not None]
        ttft = [r.t_first - r.t_arrive for r in reqs
                if r.t_first is not None]
        tpot = [(r.t_finish - r.t_first) / (len(r.out) - 1) for r in fin
                if r.t_finish is not None and r.t_first is not None
                and len(r.out) > 1]
        pfx = self.sched.prefix
        on = pfx is not None        # NOT truthiness: an empty index is falsy
        al = self.kv.alloc
        jit_total = self.jit_tracker.publish(self._c_jit)
        m = dict(self.metrics)
        m.update({
            "finished": len(fin),
            "rejects": int(self._c_rejects.total()),
            "stalls": int(self._c_stalls.total()),
            "admissions": self.sched.n_admissions,
            "evictions": self.sched.n_evictions,
            "cow_copies": self.sched.n_cow_copies,
            "decode_steps": self.decode_steps,
            "prefix_cache": on,
            "prefix_hit_tokens": pfx.hit_tokens if on else 0,
            "prefix_lookup_tokens": pfx.lookup_tokens if on else 0,
            "prefix_hit_rate": pfx.hit_rate if on else 0.0,
            "prefix_windowed_hit_rate": pfx.windowed_hit_rate if on else 0.0,
            "prefix_pages_indexed": len(pfx) if on else 0,
            "prefill_chunk": self.prefill_chunk,
            "occupancy": (m["occupancy_sum"] / m["steps"]
                          if m["steps"] else 0.0),
            "latency_p50_s": percentile(lat, 50),
            "latency_p99_s": percentile(lat, 99),
            "ttft_p50_s": percentile(ttft, 50),
            "ttft_p99_s": percentile(ttft, 99),
            "tpot_p50_s": percentile(tpot, 50),
            "tpot_p99_s": percentile(tpot, 99),
            "step_ms_p50": self._h_step.percentile(50, mac=self._mac),
            "step_ms_p99": self._h_step.percentile(99, mac=self._mac),
            "pages_free": al.n_free_strict,
            "pages_cached": al.n_cached,
            "pages_held": al.n_held,
            "kv_pool_bytes": self.kv.mem_bytes(),
            "kv_bytes_per_token": self.kv.kv_bytes_per_token(),
            "kv_capacity_tokens": (self.kv.n_pages - 1) * self.kv.page_size,
            "kv_cache_dtype": self.cfg.kv_cache_dtype,
            "page_size": self.kv.page_size,
            "n_pages": self.kv.n_pages,
            "n_slots": self.kv.n_slots,
            "mac_mode": self.cfg.mac.mode,
            "attention_backend": self.cfg.attention_backend,
            "device": str(self.device),
            "cuda_graphs": self.cuda_graphs,
            "jit_compiles": jit_total,
            "jit_compiles_by_step": self.jit_tracker.counts(),
        })
        m.update(_mesh_stats(self.mesh, self.cfg, self.split))
        if self.tel.time_device:
            m["device_decode_ms_p50"] = self._h_dev_decode.percentile(
                50, mac=self._mac)
            m["device_prefill_ms_p50"] = self._h_dev_prefill.percentile(
                50, mac=self._mac)
        if self.spec_k:
            rounds = int(self._c_spec_rounds.total())
            prop = int(self._c_spec_prop.total())
            acc = int(self._c_spec_acc.total())
            m.update({
                "spec_decode_k": self.spec_k,
                "spec_rounds": rounds,
                "spec_draft_tokens": prop,
                "spec_accepted_tokens": acc,
                "spec_acceptance_rate": acc / prop if prop else 0.0,
                "spec_tokens_per_round": (m["decode_tokens"] / rounds
                                          if rounds else 0.0),
                "draft_mac_mode": self.draft_cfg.mac.mode,
            })
            if self.tel.time_device:
                m["device_draft_ms_p50"] = self._h_dev_draft.percentile(
                    50, mac=self.draft_cfg.mac.mode)
                m["device_verify_ms_p50"] = self._h_dev_verify.percentile(
                    50, mac=self._mac)
        if self.tel.drift is not None and self.tel.drift.last is not None:
            m["encoded_drift_top1"] = self.tel.drift.last
        return m


# ---------------------------------------------------------------------------
# static-batch serving on the dense KV cache
# ---------------------------------------------------------------------------

def make_prefill(cfg):
    """Prefill a (B, S) batch into a dense cache from position 0: the last
    position's logits (B, 1, vocab_p) and the cache, written in place and
    carrying ``pos + S`` (the recurrent states in new tensors).
    ``extras``: the model's other prefill inputs (a vlm's ``img``, an
    encdec arch's ``enc_x``)."""
    def prefill(params, cache, tokens, **extras):
        logits, cache = apply_model(params, cfg, tokens, cache=cache,
                                    **extras)
        return logits[:, -1:], cache
    return prefill


def make_decode_step(cfg):
    """One (B, 1) decode step against the dense cache: logits (B, 1,
    vocab_p) and the cache carrying ``pos + 1``."""
    def decode_step(params, cache, tokens):
        return apply_model(params, cfg, tokens, cache=cache)
    return decode_step


def _ragged_pad(cfg, pad_lens):
    """``pad_lens`` as the reference's ``generate`` takes it: None when no
    row is padded; refused where left-pad masking is not exact."""
    if pad_lens is None:
        return None
    # analysis: allow(host-sync): pad_lens is host data
    pad = np.asarray(pad_lens, np.int32).ravel()
    if not (pad > 0).any():
        return None                       # uniform batch: the plain path
    if not supports_ragged_mask(cfg):
        raise ValueError(
            f"pad_lens: arch {cfg.arch!r} (family={cfg.family}, "
            f"flash={cfg.flash_attention}) cannot mask left pads exactly; "
            "batch equal-length prompts instead")
    return pad


def _pick(lg, greedy: bool, generator):
    """The next token (B, 1) int32 from last-position logits (B, vocab):
    argmax, or a sample by the Gumbel-max rule (as
    ``jax.random.categorical``) with draws from ``generator``."""
    if not greedy:
        if generator is None:
            raise ValueError("sampling (greedy=False) needs a "
                             "torch.Generator on the logits' device")
        u = torch.rand(lg.shape, generator=generator, device=lg.device)
        u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
        lg = lg.to(torch.float32) - torch.log(-torch.log(u))
    return torch.argmax(lg, dim=-1).to(torch.int32)[:, None]


def _states(layers) -> list:
    """The recurrent states of a dense cache (a hybrid layer's SSM state,
    an xLSTM layer's mLSTM or sLSTM state: ``STATE_KEYS``), in layer
    order; empty for other archs."""
    return [layer[k] for layer in layers for k in STATE_KEYS if k in layer]


def _static_decode(decode, params, layers, vocab, tok, pos, pad=None):
    """The static decode step on a dense cache's layers: last-position
    logits (B, vocab), the greedy token (B, 1), ``pos + 1`` and the new
    recurrent states (new tensors: the step reads the state and does not
    write it, so its warm-up before a capture changes nothing)."""
    cache = {"layers": layers, "pos": pos}
    if pad is not None:
        cache["pad"] = pad
    logits, new = decode(params, cache, tok)
    lg = logits[:, -1, :vocab]
    return lg, _pick(lg, True, None), new["pos"], _states(new["layers"])


def _all_done(done: torch.Tensor) -> bool:
    """Whether every row of the batch has emitted ``eos_id``: over every
    data row where this call holds a data row's rows (``Mesh.any``), so
    every row stops at the same step."""
    # analysis: allow(host-sync): the eos test (eos_id only)
    mine = bool(done.all())
    mesh = get_mesh()
    if mesh is None or mesh.n_data == 1 or batch_replicated():
        return mine
    return not mesh.any(not mine)


def _commit_states(layers, states) -> None:
    """Copy new recurrent states into the cache's own tensors (in
    place)."""
    for old, new in zip(_states(layers), states):
        for k in old:
            old[k].copy_(new[k])


class StaticBatch:
    """A dense KV cache of ``(batch, max_len)`` and its decode step, which
    runs as one captured CUDA graph on the card (``serve/graphs.py``
    ``Step``, one per pad layout) or eagerly (``graphs=False``).

    The step reads its tokens, ``pos`` and ``pad`` from device buffers of
    its own and writes only the cache rows at ``pos``, so the warm-up run
    before its capture changes nothing; the loop copies the next token,
    ``pos + 1`` and the new recurrent states (hybrid, xlstm) back into
    those buffers on the device, and waits for the host only to test
    ``eos_id``.  A hybrid or meta-token arch's cache holds ``max_len +
    meta_tokens`` rows (``init_cache``); an encdec arch's holds
    ``enc_len`` cross frames (default ``max_len // enc_len_ratio``), which
    a prefill given ``enc_x`` of that many frames fills in place."""

    def __init__(self, params, cfg, batch: int, max_len: int, *, device,
                 graphs: bool, enc_len: Optional[int] = None):
        self.params, self.cfg = params, cfg
        self.batch, self.max_len = batch, max_len
        self.device = torch.device(device)
        self.graphs = graphs
        cache = init_cache(cfg, batch, max_len, device=self.device,
                           enc_len=enc_len)
        self.layers, self.pos = cache["layers"], cache["pos"]
        i32 = dict(dtype=torch.int32, device=self.device)
        self.tok = torch.zeros((batch, 1), **i32)
        self.pad = torch.zeros((batch,), **i32)
        self._prefill = make_prefill(cfg)
        self._decode = make_decode_step(cfg)
        self.steps = {}                  # ragged (bool) → Step
        self.decode_steps = 0
        self._marks = []

    @property
    def captures(self) -> int:
        return sum(s.captures for s in self.steps.values())

    def cache_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.layers))

    def _step(self, ragged: bool) -> Step:
        if ragged not in self.steps:
            # bound to the params and the cache, not to self: a graph and
            # its memory pool go with the last reference to this batch
            fn = functools.partial(_static_decode, self._decode, self.params,
                                   self.layers, self.cfg.vocab_size)
            self.steps[ragged] = Step("decode_ragged" if ragged else "decode",
                                      fn, self.device, self.graphs)
        return self.steps[ragged]

    def _mark(self) -> None:
        """A decode step's start (and the loop's end) on the card's
        timeline (a CUDA event: no sync) or the host clock."""
        if self.device.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self._marks.append(e)
        else:
            self._marks.append(time.perf_counter())

    def step_ms(self) -> list:
        """Each decode step of the last ``run``, in ms from its start to
        the next one's (read after the run's tokens reached the host,
        which waited for the card)."""
        m = self._marks
        if self.device.type == "cuda":
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]

    @torch.inference_mode()
    def run(self, prompts, max_new: int, *, greedy: bool = True,
            generator=None, eos_id: Optional[int] = None,
            pad=None, extras: Optional[dict] = None) -> torch.Tensor:
        """``generate`` on this cache: prompts (batch, S) → tokens (batch,
        n ≤ max_new) int32 on the device; ``pad`` (batch,) left-pad slots
        or None; ``extras`` the prefill's other inputs (a vlm's ``img``,
        an encdec arch's ``enc_x``), moved to the device.  Each decode
        step is marked for ``step_ms``."""
        B, S = prompts.shape
        if B != self.batch or S + max_new > self.max_len:
            raise ValueError(f"a ({B}, {S}) batch with {max_new} new tokens "
                             f"does not fit a ({self.batch}, {self.max_len})"
                             " cache")
        reset_cache(self.layers)
        self.pos.zero_()
        cache = {"layers": self.layers, "pos": self.pos}
        ragged = pad is not None
        if ragged:
            self.pad.copy_(torch.as_tensor(pad, dtype=torch.int32))
            cache["pad"] = self.pad
        extras = {k: torch.as_tensor(v).to(self.device)
                  for k, v in (extras or {}).items()}
        logits, cache = self._prefill(self.params, cache,
                                      prompts.to(self.device), **extras)
        self.pos.copy_(cache["pos"])
        _commit_states(self.layers, _states(cache["layers"]))
        tok = _pick(logits[:, -1, :self.cfg.vocab_size], greedy, generator)
        step = self._step(ragged)
        args = (self.tok, self.pos) + ((self.pad,) if ragged else ())
        out = torch.empty((B, max_new), dtype=torch.int32, device=self.device)
        done = torch.zeros((B, 1), dtype=torch.bool, device=self.device)
        self._marks = []
        n = 0
        for i in range(max_new):
            if eos_id is not None:
                tok = tok.masked_fill(done, eos_id)
                done = done | (tok == eos_id)
            out[:, i:i + 1] = tok
            n = i + 1
            if i + 1 == max_new:         # the next logits would be unused
                break
            if eos_id is not None and _all_done(done):
                break
            self._mark()
            self.tok.copy_(tok)
            lg, nxt, new_pos, states = step(*args)
            self.pos.copy_(new_pos)
            _commit_states(self.layers, states)
            tok = nxt if greedy else _pick(lg, False, generator)
            self.decode_steps += 1
        self._mark()
        return out[:, :n]


def generate(params, cfg, prompts, max_new: int = 16,
             max_len: Optional[int] = None, extras: Optional[dict] = None,
             greedy: bool = True, generator=None,
             eos_id: Optional[int] = None, pad_lens=None,
             cuda_graphs: Optional[bool] = None, mesh=None) -> torch.Tensor:
    """Batched generation over a dense KV cache (the reference's
    ``generate``): prompts (B, S) → tokens (B, ≤ max_new) int32 on the
    params' device.

    Greedy, or with ``greedy=False`` sampled from the logits with draws
    from ``generator`` (a ``torch.Generator`` on that device; the
    reference's ``jax.random`` draws have no counterpart, so sampled tokens
    are not the reference's).  ``eos_id``: rows that emit it repeat it from
    then on, and the loop ends once every row has.  ``pad_lens`` (B,):
    left-pad slots per row; pad keys are masked and positions shifted, so
    each row decodes as it would alone (``supports_ragged_mask``; refused
    for MLA, SSM and meta-token archs, whose state ingests the pads).
    ``extras``: the prefill's other inputs, such as a vlm's ``img`` (B,
    n_patches, d) or an encdec arch's ``enc_x`` (B, S_enc, d), whose
    frames the prefill encodes into the cross K/V the decode steps read
    (without it they read zeros of ``max_len // enc_len_ratio`` frames,
    as the reference's); the decode steps take none.  The cache holds
    ``max_len`` (default ``S + max_new + meta_tokens``) plus
    ``meta_tokens`` rows, as the reference's.  No decode step is wasted:
    one prefill and at most ``max_new - 1`` decode steps.  On the card the
    decode step is a captured CUDA graph (``cuda_graphs=False`` runs it
    eagerly).

    ``mesh``: generate as one rank of it, as the reference's ``generate``
    runs under an active mesh: the params are cut by ``shard_params``
    (the whole params given, or a rank's ``LocalParams``), every step
    runs under the mesh (eagerly), and where the data axis divides B
    this data row runs its rows alone, their ``extras`` rows with them
    (a vlm's ``img`` and an encdec arch's ``enc_x`` reach the sharded
    prefill whole on every model rank), and one all-gather puts the
    tokens together; every rank returns all B rows."""
    if mesh is not None:
        params = shard_params(params, cfg, mesh)
    dev = params["embed"]["table"].device
    prompts = torch.as_tensor(prompts).to(dev)
    B, S = prompts.shape
    pad = _ragged_pad(cfg, pad_lens)
    lo, hi = cache_rows("k", B, mesh)
    split = (lo, hi) != (0, B)
    extras = {k: torch.as_tensor(v)[lo:hi] for k, v in (extras or {}).items()}
    enc_x = extras.get("enc_x")
    with set_mesh(mesh), replicated_batch(not split):
        # the cache at this rank's kv heads and its data row's rows
        sb = StaticBatch(params, cfg, hi - lo,
                         max_len or (S + max_new + cfg.meta_tokens),
                         device=dev, graphs=_graphs_on(dev, cuda_graphs, mesh),
                         enc_len=None if enc_x is None else enc_x.shape[1])
        out = sb.run(prompts[lo:hi], max_new, greedy=greedy,
                     generator=generator, eos_id=eos_id,
                     pad=None if pad is None else pad[lo:hi], extras=extras)
    if not split:
        return out
    # analysis: allow(host-sync): the tokens' one gather over the data axis
    return _gather_rows(mesh, out.cpu(), split).to(dev)


class ServeEngine:
    """Static-batch serving engine: fixed-batch greedy decode over the
    dense KV cache (the baseline the continuous ``Engine`` is measured
    against).

    Requests are served in chunks of ``batch_slots``, each left-padded to
    its longest prompt and run by ``generate`` to completion before the
    next starts.  Where ``supports_ragged_mask`` holds, the pad slots are
    masked and positions shifted per row, so each request decodes as it
    would alone; MLA latents, SSM state and meta tokens ingest the pads
    unmasked, as in the reference.  A chunk's cache holds ``S + max_new +
    8 + meta_tokens`` positions (plus ``meta_tokens``, ``init_cache``), as
    in the reference (whose ``max_len`` argument is kept and, as there,
    not used).  No image reaches a vlm's prefill and no ``enc_x`` an
    encdec arch's, whose decoder then attends over a zero cross cache, as
    in the reference.

    Each chunk builds its own cache and, on the card, captures its decode
    step into a CUDA graph; both are dropped when the chunk ends, as the
    reference builds its cache per call.  ``stats()["jit_compiles"]``
    counts the captures.  ``cuda_graphs=False`` runs the same functions
    eagerly.  ``device`` defaults to the card; ``params`` must already
    live there.  ``mesh``: serve as one rank of it, as ``Engine`` (MLA,
    vlm and encdec archs too); the dense caches hold this rank's kv heads
    (the reference splits them over the sequence instead), an MLA
    cache its whole latent.  A chunk whose requests the data axis
    divides runs its data row's rows alone (each row's cache built for
    them at the chunk's common left-pad length) and one all-gather at
    the chunk's end puts its tokens together; any other chunk runs whole
    on every row."""

    def __init__(self, params, cfg, batch_slots: int = 8,
                 max_len: int = 512, *, device=None,
                 cuda_graphs: Optional[bool] = None, mesh=None):
        self.mesh = mesh
        if mesh is not None:
            params = shard_params(params, cfg, mesh)
        self.params, self.cfg = params, cfg
        self.batch_slots, self.max_len = batch_slots, max_len
        self.device = resolve_device(device)
        self.cuda_graphs = _graphs_on(self.device, cuda_graphs, mesh)
        self.chunks = []                 # per chunk: its shape and work
        self.step_ms = []
        self.split = False               # some chunk ran split over data

    def run(self, requests, max_new: int = 32,
            eos_id: Optional[int] = None) -> list:
        """Serve a list of prompt arrays; the generated ids per request
        (each chunk's rows as long as its longest)."""
        with set_mesh(self.mesh):
            return self._run(requests, max_new, eos_id)

    def _run(self, requests, max_new, eos_id) -> list:
        results = []
        ragged_ok = supports_ragged_mask(self.cfg)
        for i in range(0, len(requests), self.batch_slots):
            chunk = requests[i:i + self.batch_slots]
            S = max(len(r) for r in chunk)
            batch = np.zeros((len(chunk), S), np.int32)
            pad = np.zeros((len(chunk),), np.int32)
            for j, r in enumerate(chunk):
                batch[j, S - len(r):] = r          # left-pad
                pad[j] = S - len(r)
            # this data row's requests of the chunk (every one where the
            # data axis does not divide them), padded to the chunk's S
            lo, hi = cache_rows("k", len(chunk), self.mesh)
            split = (lo, hi) != (0, len(chunk))
            self.split = self.split or split
            sb = StaticBatch(self.params, self.cfg, hi - lo,
                             S + max_new + 8 + self.cfg.meta_tokens,
                             device=self.device, graphs=self.cuda_graphs)
            with replicated_batch(not split):
                toks = sb.run(torch.from_numpy(batch[lo:hi]), max_new,
                              eos_id=eos_id,
                              pad=_ragged_pad(self.cfg, pad[lo:hi])
                              if ragged_ok else None)
            # analysis: allow(host-sync): the chunk's end, tokens to host
            toks = _gather_rows(self.mesh, toks.cpu(), split)
            # analysis: allow(host-sync): the gathered tokens, a host tensor
            toks = toks.numpy()
            self.step_ms.extend(sb.step_ms())
            self.chunks.append({"batch": len(chunk), "rows": hi - lo,
                                "seq": S,
                                "max_len": sb.max_len,
                                "decode_steps": sb.decode_steps,
                                "captures": sb.captures,
                                "cache_bytes": sb.cache_bytes(),
                                "tokens": int(toks.size)})
            del sb                       # its cache and graph go with it
            results.extend(toks)
        return results

    def stats(self) -> dict:
        """Totals over every ``run`` so far: chunks, decode steps, tokens,
        captures (``jit_compiles``, and by (batch, max_len)), decode step
        ms p50/p99 (card timeline), and the bytes of the largest chunk's
        dense cache."""
        ch = self.chunks
        by_shape = collections.Counter()
        for c in ch:
            by_shape[(c["batch"], c["max_len"])] += c["captures"]
        return {
            "chunks": len(ch),
            "requests": sum(c["batch"] for c in ch),
            "decode_steps": sum(c["decode_steps"] for c in ch),
            "prefill_tokens": sum(c["batch"] * c["seq"] for c in ch),
            "tokens": sum(c["tokens"] for c in ch),
            "step_ms_p50": percentile(self.step_ms, 50),
            "step_ms_p99": percentile(self.step_ms, 99),
            "kv_cache_bytes": max((c["cache_bytes"] for c in ch),
                                  default=0),
            "jit_compiles": sum(by_shape.values()),
            "jit_compiles_by_shape": dict(by_shape),
            "mac_mode": self.cfg.mac.mode,
            "device": str(self.device),
            "cuda_graphs": self.cuda_graphs,
            **_mesh_stats(self.mesh, self.cfg, self.split),
        }
