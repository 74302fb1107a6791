"""GPipe-style pipeline parallelism over one axis of a ``Mesh`` (port of
``repro/parallel/pipeline.py:pipeline_apply``).

The ranks of the axis are the stages, in axis order; each runs
``stage_fn`` on its slice of the stacked stage params.  With M
microbatches and S stages the schedule runs M + S − 1 ticks: at tick t
stage s works on microbatch t − s (stage 0 reads it from the input, a
later stage receives it from the stage before), passes its output to the
next stage, and the last stage keeps it; the last stage's outputs are
then broadcast to every stage (the reference's psum of the masked
outputs).  The bubble is (S − 1) / (M + S − 1) of the ticks.

Gradients flow through the schedule as through the reference's
``ppermute``: each hand-over's backward sends the gradient back to the
stage before, and the broadcast's backward keeps the last stage's own
gradient of the outputs (every stage computes the same loss from the
same outputs, counted once).  gloo's point-to-point calls take host
tensors only, so a hand-over of CUDA tensors goes through the host.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


class _Send(torch.autograd.Function):
    """Forward, ``y`` to global rank ``to``; backward, the gradient of
    ``y`` from there.  Returns a 0-d token that ties the send into this
    rank's graph (the caller adds ``0 · token`` to its output); ``anchor``
    (a 0-d tensor that needs a gradient) makes it a node whether or not
    ``y`` needs one, as the receiving stage expects."""

    @staticmethod
    def forward(ctx, anchor, y, to, group):
        ctx.to, ctx.group = to, group
        ctx.shape, ctx.dtype, ctx.device = y.shape, y.dtype, y.device
        dist.send(_host(y), dst=to, group=group)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        g = torch.empty(ctx.shape, dtype=ctx.dtype)
        dist.recv(g, src=ctx.to, group=ctx.group)
        return None, g.to(ctx.device), None, None


class _Recv(torch.autograd.Function):
    """Forward, a tensor shaped like ``like`` from global rank ``frm``;
    backward, its gradient sent back there.  ``anchor`` (a 0-d tensor
    that needs a gradient) makes the received tensor a node of the graph,
    so its backward runs exactly when the received tensor was used."""

    @staticmethod
    def forward(ctx, anchor, like, frm, group):
        ctx.frm, ctx.group = frm, group
        buf = torch.empty(like.shape, dtype=like.dtype)
        dist.recv(buf, src=frm, group=group)
        return buf.to(like.device)

    @staticmethod
    def backward(ctx, g):
        dist.send(_host(g), dst=ctx.frm, group=ctx.group)
        return None, None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's ``x`` on every stage; backward, the last stage
    keeps its own gradient, the others pass none on."""

    @staticmethod
    def forward(ctx, x, src, is_src, group):
        ctx.is_src = is_src
        buf = x.detach().cpu().contiguous() if is_src else \
            torch.empty(x.shape, dtype=x.dtype)
        dist.broadcast(buf, src=src, group=group)
        return buf.to(x.device)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None, None


def pipeline_apply(stage_fn, mesh, axis: str, params_stacked, x_mb):
    """Run ``x_mb`` through the S stages of ``mesh``'s ``axis``.

    ``stage_fn(stage_params, x) → y`` of x's shape.  ``params_stacked``:
    a tree whose leaves have a leading stage dim, either all S stages
    (each stage takes its own) or this stage's alone (size 1).
    ``x_mb`` (M, mb, …): the microbatches, the same on every stage.
    Returns (M, mb, …), the same on every stage."""
    S = mesh.shape[axis]
    s = mesh.axis_rank(axis)
    M = x_mb.shape[0]
    p = tree_map(lambda a: a[s] if a.shape[0] == S else a[0],
                 params_stacked)
    if S == 1:
        return torch.stack([stage_fn(p, x_mb[i]) for i in range(M)])
    group, ranks = mesh.group(axis)
    nxt = ranks[s + 1] if s + 1 < S else None
    prv = ranks[s - 1] if s > 0 else None
    grad = torch.is_grad_enabled()
    anchor = torch.zeros((), device=x_mb.device, requires_grad=grad)
    zeros = torch.zeros_like(x_mb[0])
    carry, outs, tokens = zeros, [], []
    for t in range(M + S - 1):
        i = t - s
        active = 0 <= i < M
        y = stage_fn(p, x_mb[i] if s == 0 else carry) if active else zeros
        if active and s == S - 1:
            outs.append(y)
        # the hand-over to the next stage (its backward runs exactly on
        # the ticks where this stage was active: the next stage uses what
        # it receives one tick later)
        last = t == M + S - 2        # no stage receives after it
        if nxt is not None and not last:
            if active and grad:
                tokens.append(_Send.apply(anchor, y, nxt, group))
            else:
                dist.send(_host(y), dst=nxt, group=group)
        if prv is not None and not last:
            carry = _Recv.apply(anchor, zeros, prv, group)
    mine = torch.stack(outs) if outs else torch.zeros_like(x_mb)
    out = _FromLast.apply(mine, ranks[-1], s == S - 1, group)
    for tok in tokens:
        out = out + 0 * tok
    return out

