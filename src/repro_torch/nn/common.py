"""Shared NN primitives (port of ``repro/nn/common.py``): named linears
under the MAC executor, norms, embeddings, rotary, MLPs, softcap."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.layers import MacConfig
# activation_recorder is re-exported: the calibration forward and the
# checks install it from here
from repro_torch.core.macexec import (activation_recorder,  # noqa: F401
                                      check_finite, record_activation)
from repro_torch.parallel.mesh import copy_to_model, reduce_from_model
from repro_torch.parallel.sharding import model_rank, splits


def linear_init(generator, d_in: int, d_out: int, name: str,
                mcfg: MacConfig, bias: bool = False, dtype=torch.float32,
                scale: float = None) -> dict:
    """Init a named linear: the executor owns the weight; the ``_b`` bias
    is mode-independent."""
    p = mcfg.executor.init(generator, d_in, d_out, name, mcfg, dtype=dtype,
                           scale=scale)
    if bias:
        p[name + "_b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def linear(p: dict, name: str, x: torch.Tensor, mcfg: MacConfig,
           compute_dtype=torch.float32, ways: int = 1) -> torch.Tensor:
    """Apply a named linear: recorder hook + MAC-executor dispatch +
    bias.  ``ways`` > 1: ``p`` holds this rank's tensor-parallel shard of
    the linear, one of that many, cut by its role (``linear_role``); a
    row shard's partial products are summed over the model axis before
    its bias."""
    record_activation(name, p[name], x)
    out = mcfg.executor.apply(p, name, x, mcfg, compute_dtype, ways=ways)
    if name + "_b" in p:
        out = out + p[name + "_b"].to(out.dtype)
    return check_finite(out, f"linear {name!r} ({mcfg.mode})")


# --- norms ------------------------------------------------------------------

def norm_init(d: int, kind: str = "rms", dtype=torch.float32, name="norm"
              ) -> dict:
    p = {name + "_g": torch.ones((d,), dtype=dtype)}
    if kind == "layer":
        p[name + "_bln"] = torch.zeros((d,), dtype=dtype)
    return p


def norm_apply(p: dict, x: torch.Tensor, kind: str = "rms",
               eps: float = 1e-6, name="norm") -> torch.Tensor:
    """Statistics in f32; f32 inputs keep full-f32 behaviour, other dtypes
    apply the scale in their own dtype (reference op order)."""
    g = p[name + "_g"]
    if x.dtype == torch.float32:
        if kind == "rms":
            xn = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
            return xn * g.to(torch.float32)
        mu = x.mean(-1, keepdim=True)
        var = x.var(-1, keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + eps) * g.to(torch.float32) \
            + p[name + "_bln"].to(torch.float32)
    d = x.shape[-1]
    xf = x.to(torch.float32)
    ssq = (xf * xf).sum(-1) / d
    if kind == "rms":
        r = torch.rsqrt(ssq + eps)
        return (x * r[..., None].to(x.dtype)) * g.to(x.dtype)
    mu = xf.mean(-1)
    var = torch.clamp_min(ssq - mu * mu, 0.0)
    r = torch.rsqrt(var + eps)
    out = (x - mu[..., None].to(x.dtype)) * r[..., None].to(x.dtype)
    return out * g.to(x.dtype) + p[name + "_bln"].to(x.dtype)


# --- embeddings --------------------------------------------------------------

def embed_init(generator, vocab: int, d: int, dtype=torch.float32) -> dict:
    t = torch.randn((vocab, d), generator=generator, dtype=torch.float32)
    return {"table": (t * 0.02).to(dtype)}


def embed_apply(p: dict, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    # the rows, then the cast (the same values as the reference's cast of
    # the table, without a copy of a bf16 table in f32 on every call)
    return p["table"][ids.long()].to(compute_dtype)


def vocab_embed(p: dict, ids: torch.Tensor, cfg) -> torch.Tensor:
    """The model's embedding lookup; where the head splits over the model
    axis (``parallel.sharding``) the table holds this rank's rows of the
    vocab: the tokens are looked up in its rows, zeros elsewhere, and the
    model axis sums the rows (exact: one rank holds each token's row)."""
    if splits(cfg)["head"] == 1:
        return embed_apply(p, ids, cfg.cdtype)
    n = p["table"].shape[0]
    local = ids.long() - model_rank() * n
    inside = (local >= 0) & (local < n)
    x = embed_apply(p, torch.where(inside, local, 0), cfg.cdtype)
    return reduce_from_model(x * inside[..., None].to(x.dtype))


# --- rotary -------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs    # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# --- MLP ----------------------------------------------------------------------

def act_fn(name: str):
    # the reference's 'gelu' is jax.nn.gelu's default tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_init(generator, d: int, d_ff: int, mcfg: MacConfig,
             gated: bool = True, bias: bool = False, dtype=torch.float32
             ) -> dict:
    p = {}
    p.update(linear_init(generator, d, d_ff, "wi", mcfg, bias, dtype))
    if gated:
        p.update(linear_init(generator, d, d_ff, "wg", mcfg, False, dtype))
    p.update(linear_init(generator, d_ff, d, "wo", mcfg, bias, dtype))
    return p


def mlp_apply(p: dict, x: torch.Tensor, mcfg: MacConfig, act: str = "silu",
              gated: bool = True, compute_dtype=torch.float32,
              ways: int = 1) -> torch.Tensor:
    """wi (and wg) → act → wo; ``ways`` > 1: column → act → row over a
    hidden dim cut into that many shards (the input's gradient summed
    over the model axis, ``copy_to_model``)."""
    if ways > 1:
        x = copy_to_model(x)
    h = linear(p, "wi", x, mcfg, compute_dtype, ways)
    if gated:
        h = act_fn(act)(linear(p, "wg", x, mcfg, compute_dtype, ways)) * h
    else:
        h = act_fn(act)(h)
    return linear(p, "wo", h, mcfg, compute_dtype, ways)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
