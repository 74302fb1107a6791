"""Mixture-of-Experts with capacity-based sort dispatch (port of
``repro/nn/moe.py``, and its capacity rules under a mesh, :136-160).

The reference's ``ep`` holds where the experts divide the model axis (at
a model axis of 1 too).  Then the dispatch runs per data shard of the
call's ``B·S`` token rows at the capacity of one shard, ``t_local =
B·S / D``: a rank holds ``n_experts / M`` experts, dispatches for them
only, and the pairs' contributions are summed over the model axis.  A
call that holds a data row's rows (a training batch, a split serving
step) dispatches them as its shard; a call that holds the whole batch on
every row (``parallel.mesh.replicated_batch``: every prefill chunk)
dispatches each of the D shards on its own.  Where the experts do not
divide the model axis, one global dispatch runs at the capacity of the
whole batch: a split call gathers the data rows' tokens first
(``gather_from_data``) and keeps its own rows.  The load-balance loss is
the global batch's in every case.

Routing is softmax top-k with the switch-style load-balance loss, or
DeepSeek-V3's sigmoid router, which selects on ``scores + bias`` but
weights by the unbiased scores and has no auxiliary loss.  The router and
the routed experts are plain f32 products in every MAC mode, as in the
reference (they never go through ``linear``); a shared expert is an
``mlp_apply`` under ``cfg.mac``.

Every step is a fixed-shape tensor program (no host sync), so a
forward with MoE layers captures into a CUDA graph.  Two choices keep its
results independent of the run: top-k is a stable descending sort (the
reference's ``lax.top_k`` puts the lower index first on ties, which
``torch.topk`` does not promise), and the combine sums each token's k
contributions in the reference's scatter order, one add at a time,
instead of an atomic ``index_add_``.
"""
from __future__ import annotations

import math

import torch

from .attention_mha import softmax_f32
from repro_torch.parallel.mesh import (batch_replicated, copy_to_model,
                                       gather_from_data, get_mesh,
                                       reduce_from_model)
from repro_torch.parallel.sharding import model_rank, splits
from .common import act_fn, mlp_apply, mlp_init

_F32 = torch.float32
# the expert stacks are cast to f32 (the reference's einsum promotion)
# this many bytes of f32 weight at a time, so bf16 stacks never make a
# whole f32 copy (256 x 7168 x 2048 experts would take 15 GB each)
_CAST_BYTES = 1 << 30


def moe_init(generator, cfg) -> dict:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    std = 1.0 / math.sqrt(d)

    def randn(*shape):
        return torch.randn(shape, generator=generator, dtype=_F32)

    # in place: a full-width stack is 15 GB of f32 before its cast
    p = {"router": {"w": randn(d, E).mul_(std)},
         "experts_wi": randn(E, d, f).mul_(std).to(cfg.pdtype),
         "experts_wg": randn(E, d, f).mul_(std).to(cfg.pdtype),
         "experts_wo": randn(E, f, d).div_(math.sqrt(f)).to(cfg.pdtype)}
    if cfg.router_type == "sigmoid":
        p["router"]["bias"] = torch.zeros((E,), dtype=_F32)
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(generator, d, cfg.n_shared_experts * f,
                               cfg.mac, gated=True, dtype=cfg.pdtype)
    return p


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (T, k) of the k largest entries of each row, largest first
    and, on ties, the lower index first (``jax.lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[:, :k]


def route(p: dict, x2: torch.Tensor, cfg):
    """Router → (topk_idx (T,k) int32, topk_w (T,k) f32, aux_loss 0-d)."""
    logits = x2.to(_F32) @ p["router"]["w"].to(_F32)
    k = cfg.top_k
    if cfg.router_type == "sigmoid":          # DeepSeek-V3, aux-free
        scores = torch.sigmoid(logits)
        idx = top_k(scores + p["router"]["bias"][None, :], k)
        w = torch.gather(scores, 1, idx)
        w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
        aux = torch.zeros((), dtype=_F32, device=x2.device)
    else:
        probs = softmax_f32(logits)
        idx = top_k(probs, k)
        w = torch.gather(probs, 1, idx)
        if cfg.norm_topk:
            w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
        # switch-style load balance: E · Σ_e f_e · P̄_e
        E = cfg.n_experts
        first = torch.zeros((x2.shape[0], E), dtype=_F32, device=x2.device)
        first.scatter_(1, idx[:, :1], 1.0)
        f, pbar = first.mean(0), probs.mean(0)
        mesh = get_mesh()
        if mesh is not None and mesh.n_data > 1 and not batch_replicated():
            f, pbar = _global_means(mesh, first, probs, pbar)
        aux = E * torch.sum(f * pbar)
    return idx.to(torch.int32), w.to(_F32), aux


def _global_means(mesh, first, probs, pbar):
    """f_e and P̄_e over the global batch, the reference's logical means,
    from this data rank's tokens where the call holds its data row's rows
    (a call that holds the whole batch has them already): the counts and
    probability sums summed over the data axis (equal token counts a
    rank).  P̄_e keeps this rank's mean's gradient (the value is the
    global mean's): the trainer's average of the data ranks' gradients is
    then the global mean's gradient, once."""
    n = first.shape[0] * mesh.n_data
    sums = mesh.all_reduce_sum(torch.stack([first.sum(0),
                                            probs.detach().sum(0)]),
                               "data") / n
    return sums[0], pbar + (sums[1] - pbar).detach()


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for a call over ``n_tokens`` tokens (B·S, pads
    included, as the reference counts them)."""
    return max(4, int(cfg.capacity_factor * n_tokens * cfg.top_k
                      / cfg.n_experts))


def dispatch_plan(idx: torch.Tensor, n_experts: int, cap: int):
    """The reference's sort dispatch of (token, choice) pairs: ``order``
    (stable argsort by expert), ``tid_s`` (each sorted pair's token),
    ``keep`` (within its expert's first ``cap``) and ``slot`` (its row
    in the ``(E·cap + 1)`` buffer; the last row takes the dropped)."""
    T, k = idx.shape
    key = idx.reshape(-1).long()
    order = torch.sort(key, stable=True).indices
    key_s = key[order]
    tid_s = torch.div(order, k, rounding_mode="floor")
    counts = torch.zeros((n_experts,), dtype=torch.long, device=idx.device)
    counts.scatter_add_(0, key_s, torch.ones_like(key_s))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * k, device=idx.device) - starts[key_s]
    keep = rank < cap
    slot = torch.where(keep, key_s * cap + rank,
                       torch.full_like(key_s, n_experts * cap))
    return order, tid_s, keep, slot


def _expert_ffn_local(wi, wg, wo, buf, act):
    """Every expert over its capacity rows: buf (E, C, d) → (E, C, d) f32.
    Products in f32 (bf16 weights cast a chunk of experts at a time); the
    hidden state is rounded to the weights' dtype before ``wo``, as the
    reference does."""
    E, f = wi.shape[0], wi.shape[2]
    step = E if wi.dtype == _F32 else \
        max(1, _CAST_BYTES // (wi.shape[1] * f * 4))
    outs = []
    for e0 in range(0, E, step):
        sl = slice(e0, e0 + step)
        b = buf[sl].to(_F32)
        h = torch.bmm(b, wi[sl].to(_F32))
        g = torch.bmm(b, wg[sl].to(_F32))
        h = act_fn(act)(g) * h
        outs.append(torch.bmm(h.to(wi.dtype).to(_F32), wo[sl].to(_F32)))
    return outs[0] if len(outs) == 1 else torch.cat(outs, 0)


def dispatch_compute(x2, idx, w, wi, wg, wo, *, capacity: int, act: str,
                     n_experts: int = None, lo: int = 0, reduce=None):
    """Capacity-based sort dispatch + expert FFN + combine: x2 (T,d)
    tokens, idx/w (T,k) routing, wi/wg/wo the (E, …) expert stacks →
    (T, d) f32.

    Expert parallelism: the stacks hold experts ``[lo, lo + E)`` of
    ``n_experts``; the plan is the whole one (every rank keeps and drops
    the pairs a single device would), a pair of another rank's expert
    contributes zeros, and ``reduce`` sums the (T, k, d) contributions
    over the ranks before the combine: each pair's lives on one rank, so
    the sum is exact and every rank combines what a single device
    would, in its order."""
    T, d = x2.shape
    k = idx.shape[1]
    E = wi.shape[0]
    order, tid_s, keep, slot = dispatch_plan(idx, n_experts or E, capacity)
    if n_experts and n_experts != E:
        first = lo * capacity
        keep = keep & (slot >= first) & (slot < first + E * capacity)
        slot = torch.where(keep, slot - first,
                           torch.full_like(slot, E * capacity))
    buf = torch.zeros((E * capacity + 1, d), dtype=x2.dtype,
                      device=x2.device)
    buf[slot] = x2[tid_s]
    y = _expert_ffn_local(wi, wg, wo,
                          buf[:-1].reshape(E, capacity, d), act)
    y = torch.cat([y.reshape(E * capacity, d).to(_F32),
                   torch.zeros((1, d), dtype=_F32, device=x2.device)], 0)
    wgt_s = w.reshape(-1)[order]
    contrib = y[slot] * torch.where(keep, wgt_s, 0.0)[:, None]
    # the combine: token t's k pairs, added one at a time in their
    # sorted order (the reference's scatter-add order), from 0
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * k, device=x2.device)
    seq = torch.sort(pos.reshape(T, k), dim=1).values     # sorted slots
    c = contrib[seq]                                       # (T, k, d)
    if reduce is not None:
        c = reduce(c)
    out = torch.zeros((T, d), dtype=_F32, device=x2.device)
    for j in range(k):
        out = out + c[:, j]
    return out


def _split_rows(T: int, D: int) -> int:
    """Token rows of one data shard of a call over ``T`` rows that holds
    the whole batch; raises where ``D`` does not divide them, as the
    reference's ``shard_map`` over the data axis does."""
    if T % D:
        raise ValueError(
            f"the MoE dispatch cuts a call's {T} token rows into {D} data "
            f"shards ({D} does not divide them), as the reference's "
            "shard_map does (src/repro/nn/moe.py:143-157)")
    return T // D


def moe_apply(p: dict, x: torch.Tensor, cfg):
    """MoE FFN over x (B, S, d) → (out, aux_loss)."""
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    idx, w, aux = route(p, x2, cfg)
    sp = splits(cfg)
    mesh = get_mesh()
    D = 1 if mesh is None else mesh.n_data
    M = 1 if mesh is None else mesh.n_model
    ep = sp["experts"] > 1              # this rank holds n_experts / M
    if ep:
        # training: the tokens and their routing weights enter this rank's
        # experts only, so their gradients sum over the model axis
        x2e, w = copy_to_model(x2), copy_to_model(w)
    else:
        x2e = x2

    def dispatch(xs, ids, ws, n_tokens):
        return dispatch_compute(
            xs, ids, ws, p["experts_wi"], p["experts_wg"], p["experts_wo"],
            capacity=capacity(cfg, n_tokens), act=cfg.act,
            n_experts=cfg.n_experts,
            lo=model_rank() * p["experts_wi"].shape[0],
            reduce=reduce_from_model if ep else None)

    T = B * S
    whole = D == 1 or batch_replicated()
    if cfg.n_experts % M == 0:
        # the reference's ep: capacity from one data shard's tokens,
        # t_local; a call's shard is its rows, or each of D shards of a
        # call that holds them all
        t = _split_rows(T, D) if whole else T
        outs = [dispatch(x2e[i:i + t], idx[i:i + t], w[i:i + t], t)
                for i in range(0, T, t)]
        out = outs[0] if len(outs) == 1 else torch.cat(outs, 0)
    elif whole:
        # one global dispatch over a batch this call holds whole
        out = dispatch(x2e, idx, w, T)
    else:
        # one global dispatch over every data row's tokens; this row's
        # output rows kept (a token's output depends on the others'
        # only through the drops, which carry no gradient)
        r = mesh.data_rank
        out = dispatch(gather_from_data(x2e), gather_from_data(idx),
                       gather_from_data(w), T * D)[r * T:(r + 1) * T]
    out = out.to(cfg.cdtype)
    if cfg.n_shared_experts:
        out = out + mlp_apply(p["shared"], x2, cfg.mac, cfg.act, True,
                              cfg.cdtype, sp["shared"])
    return out.reshape(B, S, d), aux
