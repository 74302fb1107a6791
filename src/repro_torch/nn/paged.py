"""Paged KV-cache primitives (port of ``repro/nn/paged.py``).

Layout: one pool of fixed-size pages per layer,

    pool_k / pool_v : (n_pages, page_size, n_kv_heads, head_dim)

indexed per sequence through a page table ``pages (B, max_pages)`` int32
and ``lens (B,)`` int32 (tokens already cached).  Page 0 is the scratch
page: unassigned table entries and positions past the table land there and
are masked on read.  Quantized pools (int8, or uint8 = packed int4)
carry f32 scale side pools ``(n_pages, page_size, n_kv_heads)``.  The
pools are written in place (the reference donates them to its jitted
steps instead).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.paged_attention import gqa_group
from repro_torch.quant.kvcache import dequantize_kv, kv_mode_of, quantize_kv
from .attention_mha import NEG_INF, softmax_f32
from .common import softcap


def _page_slots(pages: torch.Tensor, positions: torch.Tensor, ps: int):
    """(page id, in-page offset) per (B, S) position.  Positions past the
    table width and positions in unassigned entries both resolve to the
    scratch page (0) — never a real page, whose offsets may hold live
    tokens."""
    P = pages.shape[1]
    positions = positions.long()
    pi = positions // ps                                   # (B, S)
    pid = torch.gather(pages.long(), 1, torch.clamp(pi, max=P - 1))
    pid = torch.where(pi < P, pid, torch.zeros_like(pid))
    return pid, positions % ps


def scatter_kv(pool: torch.Tensor, pages: torch.Tensor,
               positions: torch.Tensor, val: torch.Tensor) -> None:
    """Write ``val`` (B, S, H, D) at absolute ``positions`` (B, S) through
    the page table, in place."""
    pid, off = _page_slots(pages, positions, pool.shape[1])
    pool[pid, off] = val.to(pool.dtype)


def scatter_kv_quant(pool: torch.Tensor, scale: torch.Tensor,
                     pages: torch.Tensor, positions: torch.Tensor,
                     val: torch.Tensor) -> None:
    """Quantize fresh rows ``val`` (B, S, H, D) to the pool's storage mode
    and write the value bytes and their f32 per-token per-head scales
    through the page table, in place."""
    q, s = quantize_kv(val, kv_mode_of(pool))
    pid, off = _page_slots(pages, positions, pool.shape[1])
    pool[pid, off] = q
    scale[pid, off] = s


def gather_kv(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """(n_pages, ps, H, D) pool + (B, P) table → (B, P·ps, H, D) view."""
    B, P = pages.shape
    ps = pool.shape[1]
    return pool[pages.long()].reshape(B, P * ps, *pool.shape[2:])


def gather_kv_dequant(pool: torch.Tensor, scale: torch.Tensor,
                      pages: torch.Tensor) -> torch.Tensor:
    """Quantized-pool gather for the reference path: (n_pages, ps, H, Dp)
    pool + (n_pages, ps, H) scales + (B, P) table → dequantized f32
    (B, P·ps, H, D) view."""
    B, P = pages.shape
    ps = pool.shape[1]
    idx = pages.long()
    out = dequantize_kv(pool[idx], scale[idx], kv_mode_of(pool))
    return out.reshape(B, P * ps, *out.shape[3:])


def paged_attn_decode(q, k, v, kv_of_q: np.ndarray, *, scale: float,
                      q_pos, k_pos, k_valid, window=None, cap=None):
    """Attention over a gathered page view with per-row positions.

    q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D); q_pos (B, Sq); k_pos (Sk,);
    k_valid (B, Sk).  Mirrors the dense ``mha`` op order (grouped layout,
    f32 logits and softmax); fully-masked rows stay finite because NEG_INF
    is a finite f32 sentinel."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    f32 = torch.float32
    kv_np = np.asarray(kv_of_q)
    group = gqa_group(kv_np, Hq, Hkv)
    if group is not None:
        G, He = group, Hq // group
    else:
        idx = torch.as_tensor(kv_np, dtype=torch.long, device=k.device)
        k = k.index_select(2, idx)
        v = v.index_select(2, idx)
        G, He = 1, Hq
    qg = (q * torch.tensor(scale, dtype=q.dtype, device=q.device)
          ).reshape(B, Sq, He, G, D)
    lg = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(f32), k.to(f32))
    lg = softcap(lg, cap)
    d = q_pos[:, :, None] - k_pos[None, None, :]           # (B, Sq, Sk)
    ok = (d >= 0) & k_valid[:, None, :]
    if window is not None:
        ok = ok & (d < window)
    lg = torch.where(ok[:, None, None], lg,
                     torch.tensor(NEG_INF, dtype=f32, device=lg.device))
    out = torch.einsum("bhgqk,bkhd->bqhgd", softmax_f32(lg), v.to(f32))
    return out.reshape(B, Sq, Hq, -1).to(q.dtype)
