"""Optimizers (functional, optax-like): AdamW, Adafactor, SGD-momentum
(port of ``repro/optim/optimizers.py``).

``init(params) → state`` and ``update(grads, state, params, lr) →
(new_params, new_state)`` over trees of tensors, with the reference's
state trees (``{"m", "v", "t"}``; ``{"f": (per-leaf {"vr", "vc"} or
{"v"}, in ``tree_flatten`` order), "t"}``; ``{"m"}``), so a state
carries across packages and checkpoints leaf for leaf.  Everything is f32
on the params' device; nothing is updated in place.

Under a mesh, ``update(..., dims=)`` takes the model axis's dim of each
param leaf (``parallel.statesharding.param_dims``; the leaves are this
rank's shards).  AdamW and SGD are elementwise and ignore it; Adafactor's
row and column means over a cut dim, its ``vr`` mean and its update's
RMS over a cut leaf are reduced over the model axis, so every rank
updates its shard as the whole leaf's update would.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.parallel.mesh import get_mesh
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable      # (grads, state, params, lr) -> (new_params, state)


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=_F32, device=p.device)


def _split(trees_of_tuples, n: int, spec):
    return [tree_unflatten(spec, [t[i] for t in trees_of_tuples])
            for i in range(n)]


def _zip_leaves(*trees):
    flat = [tree_flatten(t) for t in trees]
    spec = flat[0][1]
    for _, sp in flat[1:]:
        if sp != spec:
            raise ValueError("optimizer: grads, state and params differ in "
                             "structure")
    return list(zip(*(ls for ls, _ in flat))), spec


def adamw(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=_device_of(params))}

    def update(grads, state, params, lr, dims=None):
        t = state["t"] + 1
        b1t = 1 - b1 ** t.to(_F32)
        b2t = 1 - b2 ** t.to(_F32)

        def upd(g, m, v, p):
            g = g.to(_F32)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            step = (m2 / b1t) / (torch.sqrt(v2 / b2t) + eps)
            step = step + weight_decay * p.to(_F32)
            return (p.to(_F32) - lr * step).to(p.dtype), m2, v2

        rows, spec = _zip_leaves(grads, state["m"], state["v"], params)
        new_p, m, v = _split([upd(*r) for r in rows], 3, spec)
        return new_p, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adafactor(eps=1e-30, clip_thresh=1.0, decay=0.8) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern, 2018), no
    momentum.  A leaf of two or more dims keeps row and column means; on
    the reference's stacked layer layout a per-layer vector is such a
    leaf, so the port's state matches leaf for leaf."""
    def _factored(p):
        return p.dim() >= 2

    def init(params):
        fs = []
        for p in tree_flatten(params)[0]:
            dev = p.device
            if _factored(p):
                fs.append({"vr": torch.zeros(p.shape[:-1], dtype=_F32,
                                             device=dev),
                           "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                             dtype=_F32, device=dev)})
            else:
                fs.append({"v": _zeros_f32(p)})
        return {"f": tuple(fs),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=_device_of(params))}

    def update(grads, state, params, lr, dims=None):
        t = state["t"] + 1
        beta = 1.0 - (t.to(_F32) + 1.0) ** (-decay)
        g_leaves, spec = tree_flatten(grads)
        p_leaves, p_spec = tree_flatten(params)
        if p_spec != spec:
            raise ValueError("adafactor: grads and params differ")
        if dims is None:
            dims = [-1] * len(p_leaves)
        mesh = get_mesh()
        new_p, fs = [], []
        for g, s, p, d in zip(g_leaves, state["f"], p_leaves, dims):
            g = g.to(_F32)
            g2 = g * g + eps
            nd = p.dim()
            if _factored(p):
                vr = beta * s["vr"] + (1 - beta) * _mean(g2, -1, d == nd - 1,
                                                         mesh)
                vc = beta * s["vc"] + (1 - beta) * _mean(g2, -2, d == nd - 2,
                                                         mesh)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp_min(_mean(vr, -1, d == nd - 2, mesh,
                                                 keepdim=True)[..., None],
                                           eps))
                step = g * torch.rsqrt(denom + eps)
                fs.append({"vr": vr, "vc": vc})
            else:
                v = beta * s["v"] + (1 - beta) * g2
                step = g * torch.rsqrt(v + eps)
                fs.append({"v": v})
            # update clipping (RMS ≤ clip_thresh), over the whole leaf
            if d >= 0:
                sq = mesh.all_reduce_sum((step * step).sum())
                ms = sq / (step.numel() * mesh.n_model)
            else:
                ms = torch.mean(step * step)
            rms = torch.sqrt(ms + eps)
            step = step / torch.clamp_min(rms / clip_thresh, 1.0)
            new_p.append((p.to(_F32) - lr * step).to(p.dtype))
        return tree_unflatten(spec, new_p), {"f": tuple(fs), "t": t}

    return Optimizer(init, update)


def sgd(momentum=0.9) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params)}

    def update(grads, state, params, lr, dims=None):
        def upd(g, m, p):
            m2 = momentum * m + g.to(_F32)
            return (p.to(_F32) - lr * m2).to(p.dtype), m2
        rows, spec = _zip_leaves(grads, state["m"], params)
        new_p, m = _split([upd(*r) for r in rows], 2, spec)
        return new_p, {"m": m}

    return Optimizer(init, update)


def _mean(x: torch.Tensor, dim: int, cut: bool, mesh, keepdim=False):
    """``x.mean(dim)``; where the model axis cuts ``dim`` into equal
    shards, the mean over the whole dim (this rank's sum reduced over the
    axis)."""
    if not cut:
        return x.mean(dim, keepdim=keepdim)
    tot = mesh.all_reduce_sum(x.sum(dim, keepdim=keepdim))
    return tot / (x.shape[dim] * mesh.n_model)


def _device_of(tree) -> torch.device:
    leaves = tree_flatten(tree)[0]
    return leaves[0].device if leaves else torch.device("cpu")


def make_optimizer(name: str) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor, "sgd": sgd}[name]()
