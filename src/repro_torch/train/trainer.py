"""train_step factory: loss → grads → clip → (int8 error-feedback
all-reduce) → lr → optimizer, with microbatch gradient accumulation and
per-layer remat (``cfg.remat``, inside the model) — port of
``repro/train/trainer.py``.

The train state is the reference's tree: ``{"params", "opt", "step"}``
(and ``"err"`` with ``grad_compress``) with the params in the reference's
layout (per-layer leaves stacked ``(L, …)`` under each stage's name,
``models.stack_layers``), so the optimizer state and the step checkpoints
are the reference's leaf for leaf.  The step is functional: it returns a
new state and leaves its input intact.

The loss is the reference's: the LM loss, plus ``mtp_weight`` times the
multi-token-prediction head's loss with ``cfg.mtp``, plus
``aux_loss_weight`` times the MoE layers' summed router loss (switch-style
load balance for a softmax router, 0 for the sigmoid router, whose
``bias`` gets a zero gradient).

Under a mesh (``parallel.mesh.set_mesh`` around the step, a state from
``init_train_state(..., mesh=)``: this rank's shards, ``parallel.
statesharding``) the step computes what the reference's pjit step
computes on the logical arrays: every rank is handed the global batch and
keeps its data rank's rows (``data_rows``); the gradients of the data
ranks' losses are averaged over the data axis (one exchange a step); the
loss is the global one, from the vocab-parallel loss where the model axis
cuts the vocab; clipping takes the logical gradient's norm; the optimizer
updates each shard as the whole leaf.  ``grad_compress`` under a mesh
runs the reference's ``_compressed_allreduce``: its gradients arrive
already reduced (every data rank holds the same), so the clipped global
gradient is error-feedback quantized to int8 at each whole leaf's scale,
the codes summed over the data axis as int32 and divided by its size:
the codes themselves, with an error buffer equal on every data rank.  It
quantizes under any mesh, a 1xM one too (``"data"`` is always one of
the reference mesh's axes); without a mesh the state carries ``err`` and
the step does not quantize, as the reference's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import (apply_model, init_model, mtp_logits,
                                stack_layers, unstack_layers)
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               warmup_cosine)
from repro_torch.optim.compression import (decompress_int8,
                                           ef_compress_tree,
                                           init_error_buffers)
from repro_torch.parallel.mesh import AXIS_DATA, get_mesh
from repro_torch.parallel.sharding import splits
from repro_torch.parallel.statesharding import param_dims, shard_state
from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
from .losses import lm_loss, lm_loss_vocab_parallel

TrainState = dict      # {"params", "opt", "step"[, "err"]}

_F32 = torch.float32


def init_train_state(cfg, seed: int = 0, device=None,
                     grad_compress: bool = False, mesh=None) -> TrainState:
    """Params from ``seed`` (``init_model``) in the reference's layout, the
    optimizer's zero state, step 0 and, with ``grad_compress``, zero
    error-feedback buffers, on ``device`` (default: the card).  Under
    ``mesh``: this rank's shards of that state (``shard_state``; every
    rank draws the whole state first)."""
    dev = resolve_device(device)
    params = stack_layers(init_model(cfg, seed=seed, device=dev), cfg)
    opt = make_optimizer(cfg.optimizer)
    st = {"params": params, "opt": opt.init(params),
          "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if grad_compress:
        st["err"] = init_error_buffers(params)
    return st if mesh is None else shard_state(st, cfg, mesh)


def params_of(state: TrainState) -> dict:
    """The state's params in the port's per-layer layout (views), for
    ``apply_model`` and the serving engines."""
    return unstack_layers(state["params"])


def data_rows(n_rows: int, mesh, microbatch: Optional[int] = None):
    """(row indices of the global batch that this data rank takes, its
    microbatch).  The reference shards the batch's dim 0 over the data
    axis and each microbatch chunk again (the MoE layer's ``shard_map``
    splits a chunk's tokens into contiguous blocks), so in chunk ``i`` of
    ``mb`` rows data rank ``d`` takes rows ``[i·mb + d·mb/D, i·mb +
    (d+1)·mb/D)``; without a microbatch the chunk is the batch."""
    D, d = mesh.n_data, mesh.data_rank
    mb = microbatch if microbatch and microbatch < n_rows else n_rows
    if n_rows % mb or mb % D:
        raise ValueError(f"a batch of {n_rows} rows in microbatches of {mb} "
                         f"does not split over {D} data ranks")
    k = mb // D
    idx = [i * mb + d * k + j for i in range(n_rows // mb) for j in range(k)]
    return idx, (k if mb < n_rows else None)


def _sum_over_data(leaves, dtype, mesh) -> list:
    """``leaves`` summed over the data axis in one all-reduce of one
    ``dtype`` buffer, each back in its shape (in ``dtype``)."""
    flat = torch.cat([x.reshape(-1).to(dtype) for x in leaves])
    flat = mesh.all_reduce_sum(flat, AXIS_DATA)
    out, i = [], 0
    for x in leaves:
        out.append(flat[i:i + x.numel()].reshape(x.shape))
        i += x.numel()
    return out


def _mean_over_data(tree, mesh):
    """The leaves of ``tree`` averaged over the data axis (f32)."""
    if mesh.n_data == 1:
        return tree
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [
        (s / mesh.n_data).to(x.dtype)
        for s, x in zip(_sum_over_data(leaves, _F32, mesh), leaves)])


def compressed_allreduce(grads, err, mesh):
    """The reference's ``_compressed_allreduce`` on this rank's shards:
    ``ef_compress_tree`` at each whole leaf's scale (its max-abs reduced
    over the model axis), the codes summed over the data axis as int32,
    decompressed and divided by its size.  → (grads, new err)."""
    codes, scales, new_err = ef_compress_tree(
        grads, err, reduce_amax=mesh.all_reduce_max)
    spec = tree_flatten(grads)[1]
    summed = _sum_over_data(tree_leaves(codes), torch.int32, mesh)
    return tree_unflatten(spec, [
        decompress_int8(q, s) / mesh.n_data
        for q, s in zip(summed, tree_leaves(scales))]), new_err


def make_train_step(cfg, *, total_steps: int = 10000, warmup: int = 100,
                    microbatch: Optional[int] = None, clip_norm: float = 1.0,
                    grad_compress: bool = False):
    """Returns ``train_step(state, batch) → (state, metrics)``.

    batch: ``{"tokens" (B,S), "labels" (B,S)}`` int tensors or arrays
    (moved to the params' device), and a vlm's ``img`` (B, n_patches,
    d) or an encdec arch's ``enc_x`` (B, S_enc, d) when present; under a
    mesh the global batch, the same on every rank.  ``microbatch``: split
    the batch into chunks (global rows) whose f32 gradients are summed
    and divided by their count (one optimizer step and one gradient
    exchange per step; the metrics are the last chunk's, as the
    reference's scan reports them).  metrics: ``loss``, ``aux``,
    ``gnorm`` (before clipping) and ``lr``, 0-d f32 tensors, the global
    batch's under a mesh."""
    opt = make_optimizer(cfg.optimizer)
    lr_fn = warmup_cosine(cfg.learning_rate, warmup, total_steps)

    def loss_fn(params, batch):
        p = unstack_layers(params)
        extras = {k: batch[k] for k in ("img", "enc_x") if k in batch}
        vocab_parallel = get_mesh() is not None and splits(cfg)["head"] > 1
        logits, _, aux, h = apply_model(p, cfg, batch["tokens"],
                                        return_aux=True, return_hidden=True,
                                        local_logits=vocab_parallel,
                                        **extras)
        S = batch["labels"].shape[1]
        loss = (lm_loss_vocab_parallel if vocab_parallel else lm_loss)(
            logits[:, -S:], batch["labels"])
        if cfg.mtp:
            l2 = mtp_logits(p, cfg, h[:, -S:], batch["tokens"])
            loss = loss + cfg.mtp_weight * lm_loss(l2[:, :-1],
                                                   batch["labels"][:, 2:])
        return loss + cfg.aux_loss_weight * aux, (loss, aux)

    def grad_of(params, batch):
        leaves, spec = tree_flatten(params)
        xs = [leaf.detach().requires_grad_(True) for leaf in leaves]
        with torch.enable_grad():
            total, (loss, aux) = loss_fn(tree_unflatten(spec, xs), batch)
            gs = torch.autograd.grad(total, xs, allow_unused=True)
        # a leaf the loss does not reach (a stop-gradient scale) gets 0
        gs = [torch.zeros_like(x) if g is None else g
              for g, x in zip(gs, xs)]
        return tree_unflatten(spec, gs), (loss.detach(), aux.detach())

    def grads_of(params, batch, mb_size):
        B = batch["tokens"].shape[0]
        if mb_size is None or mb_size >= B:
            return grad_of(params, batch)
        n = B // mb_size
        if n * mb_size != B:
            raise ValueError(f"batch {B} is not a multiple of the "
                             f"microbatch {mb_size}")
        acc, aux = None, None
        for i in range(n):
            b = {k: v[i * mb_size:(i + 1) * mb_size]
                 for k, v in batch.items()}
            g, aux = grad_of(params, b)
            g_leaves, spec = tree_flatten(g)
            g_leaves = [x.to(_F32) for x in g_leaves]
            acc = g_leaves if acc is None else \
                [a + x for a, x in zip(acc, g_leaves)]
        return tree_unflatten(spec, [a / n for a in acc]), aux

    def train_step(state, batch):
        mesh = get_mesh()
        dev = state["step"].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        mb_size = microbatch or (cfg.microbatch or None)
        dims = None
        if mesh is not None:
            dims = param_dims(state["params"], cfg, mesh)
            rows, mb_size = data_rows(batch["tokens"].shape[0], mesh,
                                      mb_size)
            rows = torch.tensor(rows, device=dev)
            batch = {k: v[rows] for k, v in batch.items()}
        grads, (loss, aux) = grads_of(state["params"], batch, mb_size)
        if mesh is not None:
            grads = _mean_over_data(grads, mesh)
            loss = mesh.all_reduce_sum(loss.reshape(1).clone(),
                                       AXIS_DATA)[0] / mesh.n_data
        grads, gnorm = clip_by_global_norm(grads, clip_norm, dims)
        if grad_compress and mesh is not None:
            grads, err = compressed_allreduce(grads, state["err"], mesh)
            state = dict(state, err=err)
        lr = lr_fn(state["step"])                 # f32, on the host
        new_params, new_opt = opt.update(grads, state["opt"],
                                         state["params"], float(lr),
                                         dims=dims)
        new_state = dict(state, params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        return new_state, {"loss": loss, "aux": aux, "gnorm": gnorm,
                           "lr": torch.tensor(lr, dtype=_F32, device=dev)}

    return train_step
