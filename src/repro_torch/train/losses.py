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
