"""Losses (port of ``repro/train/losses.py``)."""
from __future__ import annotations

import torch


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask=None) -> torch.Tensor:
    """Token-level cross entropy.  logits (B,S,V) (possibly padded vocab),
    labels (B,S) < true vocab; with ``mask`` the mean over its weight."""
    lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(torch.float32)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def lm_loss_vocab_parallel(logits: torch.Tensor, labels: torch.Tensor
                           ) -> torch.Tensor:
    """``lm_loss`` from this rank's columns of the logits (B, S, V / TP)
    under the active mesh, whose model axis cut the vocab into equal
    column shards in rank order: the row max, the sum of exponentials and
    the target's logit are reduced over the model axis (three (B, S)
    all-reduces in place of the (B, S, V) gather).  The same value as
    ``lm_loss`` on the gathered logits up to f32 order; every rank gets
    the same loss, and its gradient reaches each rank's columns whole."""
    from repro_torch.parallel.mesh import get_mesh, reduce_from_model
    mesh = get_mesh()
    z = logits.to(torch.float32)
    n = z.shape[-1]
    m = mesh.all_reduce_max(z.detach().amax(-1).contiguous())
    se = reduce_from_model(torch.exp(z - m[..., None]).sum(-1))
    local = labels.long() - mesh.model_rank * n
    inside = (local >= 0) & (local < n)
    tgt = torch.gather(z, -1, torch.where(inside, local, 0)[..., None])
    tgt = reduce_from_model(tgt[..., 0] * inside.to(torch.float32))
    return (torch.log(se) + m - tgt).mean()
