"""Int8 gradient compression with error feedback (port of
``repro/optim/compression.py``): each tensor quantized to int8 with a
symmetric per-tensor scale, the quantization residual kept in an
error-feedback buffer and added to the next step's gradient
(Karimireddy et al., 2019).

The int8 error-feedback all-reduce over the data axis that uses these
primitives is ``train.trainer.compressed_allreduce`` (the train step's
``grad_compress``).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


def compress_int8(x: torch.Tensor, amax=None):
    """x (float) → (codes int8, scale f32 0-d).  Symmetric, per-tensor;
    ``amax``: the max-abs of the whole tensor where ``x`` is a shard of
    it (default: ``x``'s own)."""
    xf = x.to(torch.float32)
    if amax is None:
        amax = xf.abs().amax()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor
                    ) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def ef_compress_tree(grads, errors, reduce_amax=None):
    """Apply error feedback, then compress each leaf.  ``reduce_amax``
    (leaves that are shards of tensor-parallel leaves): maps the stacked
    max-abs of every leaf of this rank to the whole leaves' (a max over
    the model axis), so each shard is quantized at its whole leaf's
    scale.

    Returns (codes_tree, scales_tree, new_errors_tree)."""
    g_leaves, spec = tree_flatten(grads)
    e_leaves, e_spec = tree_flatten(errors)
    if e_spec != spec:
        raise ValueError("ef_compress_tree: grads and errors differ")
    corrected = [g.to(torch.float32) + e for g, e in zip(g_leaves, e_leaves)]
    amax = [None] * len(corrected)
    if reduce_amax is not None:
        amax = reduce_amax(torch.stack([c.abs().amax() for c in corrected]))
    codes, scales, errs = [], [], []
    for x, a in zip(corrected, amax):
        c, s = compress_int8(x, a)
        codes.append(c)
        scales.append(s)
        errs.append(x - decompress_int8(c, s))
    return (tree_unflatten(spec, codes), tree_unflatten(spec, scales),
            tree_unflatten(spec, errs))


def init_error_buffers(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
