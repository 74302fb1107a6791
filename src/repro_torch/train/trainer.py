"""train_step factory: loss → grads → clip → lr → optimizer, with
microbatch gradient accumulation and per-layer remat (``cfg.remat``,
inside the model) — port of ``repro/train/trainer.py``.

The train state is the reference's tree: ``{"params", "opt", "step"}``
with the params in the reference's layout (per-layer leaves stacked
``(L, …)`` under each stage's name, ``models.stack_layers``), so the
optimizer state and the step checkpoints are the reference's leaf for
leaf.  The step is functional: it returns a new state and leaves its
input intact.

The loss is the reference's: the LM loss, plus ``mtp_weight`` times the
multi-token-prediction head's loss with ``cfg.mtp``, plus
``aux_loss_weight`` times the MoE layers' summed router loss (switch-style
load balance for a softmax router, 0 for the sigmoid router, whose
``bias`` gets a zero gradient).  Not ported yet: the int8 error-feedback
all-reduce over data-parallel ranks (``grad_compress``, with tensor
parallelism, ROADMAP Queue A item 3), which raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import (apply_model, init_model, mtp_logits,
                                stack_layers, unstack_layers)
from repro_torch.optim import (clip_by_global_norm, make_optimizer,
                               warmup_cosine)
from repro_torch.tree import tree_flatten, tree_unflatten
from .losses import lm_loss

TrainState = dict      # {"params", "opt", "step"}

_F32 = torch.float32


def _refuse(grad_compress: bool) -> None:
    if grad_compress:
        raise NotImplementedError(
            "the int8 error-feedback gradient all-reduce (grad_compress) "
            "needs several ranks and is not ported yet (ROADMAP Queue A "
            "item 3)")


def init_train_state(cfg, seed: int = 0, device=None,
                     grad_compress: bool = False) -> TrainState:
    """Params from ``seed`` (``init_model``) in the reference's layout, the
    optimizer's zero state and step 0, on ``device`` (default: the
    card)."""
    _refuse(grad_compress)
    dev = resolve_device(device)
    params = stack_layers(init_model(cfg, seed=seed, device=dev), cfg)
    opt = make_optimizer(cfg.optimizer)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def params_of(state: TrainState) -> dict:
    """The state's params in the port's per-layer layout (views), for
    ``apply_model`` and the serving engines."""
    return unstack_layers(state["params"])


def make_train_step(cfg, *, total_steps: int = 10000, warmup: int = 100,
                    microbatch: Optional[int] = None, clip_norm: float = 1.0,
                    grad_compress: bool = False):
    """Returns ``train_step(state, batch) → (state, metrics)``.

    batch: ``{"tokens" (B,S), "labels" (B,S)}`` int tensors or arrays
    (moved to the params' device), and a vlm's ``img`` (B, n_patches,
    d) or an encdec arch's ``enc_x`` (B, S_enc, d) when present.  ``microbatch``: split the batch into
    chunks whose f32 gradients are summed and divided by their count (one
    optimizer step per step; the metrics are the last chunk's, as the
    reference's scan reports them).  metrics: ``loss``, ``aux``, ``gnorm``
    (before clipping) and ``lr``, 0-d f32 tensors."""
    _refuse(grad_compress)
    opt = make_optimizer(cfg.optimizer)
    lr_fn = warmup_cosine(cfg.learning_rate, warmup, total_steps)

    def loss_fn(params, batch):
        p = unstack_layers(params)
        extras = {k: batch[k] for k in ("img", "enc_x") if k in batch}
        logits, _, aux, h = apply_model(p, cfg, batch["tokens"],
                                        return_aux=True, return_hidden=True,
                                        **extras)
        S = batch["labels"].shape[1]
        loss = lm_loss(logits[:, -S:], batch["labels"])
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

    def grads_of(params, batch):
        mb_size = microbatch or (cfg.microbatch or None)
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
        dev = state["step"].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        grads, (loss, aux) = grads_of(state["params"], batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_fn(state["step"])                 # f32, on the host
        new_params, new_opt = opt.update(grads, state["opt"],
                                         state["params"], float(lr))
        new_state = dict(state, params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        return new_state, {"loss": loss, "aux": aux, "gnorm": gnorm,
                           "lr": torch.tensor(lr, dtype=_F32, device=dev)}

    return train_step
