"""Global-norm gradient clipping (port of ``repro/optim/clip.py``), in
f32 on the gradients' device.  Under a mesh (``dims``: the model axis's
dim of each leaf, ``parallel.statesharding``) the norm is the logical
gradient's: the squares of the cut leaves summed over the model axis,
the replicated leaves' counted once."""
import torch

from repro_torch.tree import tree_leaves, tree_map


def global_norm(tree, dims=None) -> torch.Tensor:
    leaves = tree_leaves(tree)
    sq = [torch.sum(leaf.to(torch.float32) ** 2) for leaf in leaves]
    if dims is None or all(d < 0 for d in dims):
        return torch.sqrt(sum(sq))
    from repro_torch.parallel.mesh import get_mesh
    cut = get_mesh().all_reduce_sum(
        sum(s for s, d in zip(sq, dims) if d >= 0).reshape(1))[0]
    return torch.sqrt(cut + sum(s for s, d in zip(sq, dims) if d < 0))


def clip_by_global_norm(grads, max_norm: float, dims=None):
    """→ (grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping)."""
    g = global_norm(grads, dims)
    scale = torch.clamp_max(max_norm / torch.clamp_min(g, 1e-9), 1.0)
    return tree_map(lambda leaf: (leaf.to(torch.float32) * scale
                                  ).to(leaf.dtype), grads), g
