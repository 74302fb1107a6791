"""Global-norm gradient clipping (port of ``repro/optim/clip.py``), in
f32 on the gradients' device."""
import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(leaf.to(torch.float32) ** 2)
                          for leaf in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """→ (grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    g = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(g, 1e-9), 1.0)
    return tree_map(lambda leaf: (leaf.to(torch.float32) * scale
                                  ).to(leaf.dtype), grads), g
