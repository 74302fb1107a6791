"""Core attention op with the grouped (kv-head, group) layout (port of
``repro/nn/attention_mha.py``).  Logits, softmax and the AV product run in
f32; q is scaled in its storage dtype first (reference op order)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .common import softcap

NEG_INF = -2.0e38


def _mask(q_pos, k_pos, window, causal: bool = True):
    """Allow-mask from absolute positions: (Sq, Sk) for 1-D inputs,
    (B, Sq, Sk) as soon as either side is batched."""
    if q_pos.dim() == 1 and k_pos.dim() == 1:
        d = q_pos[:, None] - k_pos[None, :]
    else:
        qp = q_pos if q_pos.dim() > 1 else q_pos[None]
        kp = k_pos if k_pos.dim() > 1 else k_pos[None]
        d = qp[:, :, None] - kp[:, None, :]
    ok = d >= 0 if causal else torch.ones_like(d, dtype=torch.bool)
    if window is not None:
        ok = ok & (d < window)
    return ok


def _apply_mask(lg, ok, k_valid):
    """Mask logits ``lg (B,He,G,Sq,Ck)`` with ``ok`` ((Sq,Ck) or
    (B,Sq,Ck)) and optional ``k_valid`` ((Ck,) or (B,Ck))."""
    if k_valid is not None:
        kv = k_valid if k_valid.dim() > 1 else k_valid[None]
        ok = (ok if ok.dim() == 3 else ok[None]) & kv[:, None, :]
    neg = torch.full((), NEG_INF, dtype=lg.dtype, device=lg.device)
    if ok.dim() == 2:
        return torch.where(ok[None, None, None], lg, neg)
    return torch.where(ok[:, None, None], lg, neg)


def softmax_f32(lg: torch.Tensor) -> torch.Tensor:
    """exp(x − max) / Σ, the reference's (jax.nn.softmax) op order."""
    e = torch.exp(lg - lg.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def mha(q, k, v, kv_of_q: np.ndarray, *, scale: float, q_pos, k_pos,
        window=None, cap=None, causal=True, chunk: int = 0,
        k_valid: Optional[torch.Tensor] = None):
    """q (B,Sq,Hq,D); k,v (B,Sk,Hkv,D[v]) → (B,Sq,Hq,Dv) in q.dtype."""
    B, Sq, Hq, D = q.shape
    Dv = v.shape[-1]
    Sk, Hkv = k.shape[1], k.shape[2]
    f32 = torch.float32
    kv_np = np.asarray(kv_of_q)
    identity = Hkv == Hq and np.array_equal(kv_np, np.arange(Hq))
    group = Hq // Hkv if Hkv and Hq % Hkv == 0 else 0
    uniform = group > 1 and np.array_equal(
        kv_np, np.minimum(np.arange(Hq) // group, Hkv - 1))
    if identity:
        G, He = 1, Hq
    elif uniform:
        G, He = group, Hkv
    else:                      # irregular map: gather K/V to q-heads once
        idx = torch.as_tensor(kv_np, dtype=torch.long, device=k.device)
        k = k.index_select(2, idx)
        v = v.index_select(2, idx)
        G, He = 1, Hq

    qg = (q * torch.full((), scale, dtype=q.dtype, device=q.device)
          ).reshape(B, Sq, He, G, D).to(f32)

    def logits_block(kb):                     # → (B,He,G,Sq,Ck) f32
        return torch.einsum("bqhgd,bkhd->bhgqk", qg, kb.to(f32))

    def weighted_v(p, vb):                    # p (B,He,G,Sq,Ck) f32
        return torch.einsum("bhgqk,bkhd->bqhgd", p, vb.to(f32))

    if chunk and Sk > chunk:
        if Sk % chunk:
            chunk = max(d for d in range(1, chunk + 1) if Sk % d == 0)
        m_i = torch.full((B, He, G, Sq), NEG_INF, dtype=f32, device=q.device)
        l_i = torch.zeros((B, He, G, Sq), dtype=f32, device=q.device)
        acc = torch.zeros((B, Sq, He, G, Dv), dtype=f32, device=q.device)
        for c0 in range(0, Sk, chunk):
            sl = slice(c0, c0 + chunk)
            kp = k_pos[..., sl]
            kvl = None if k_valid is None else k_valid[..., sl]
            lg = softcap(logits_block(k[:, sl]), cap)
            lg = _apply_mask(lg, _mask(q_pos, kp, window, causal), kvl)
            m_new = torch.maximum(m_i, lg.amax(-1))
            alpha = torch.exp(m_i - m_new)
            pexp = torch.exp(lg - m_new[..., None])
            l_i = l_i * alpha + pexp.sum(-1)
            acc = acc * alpha.permute(0, 3, 1, 2)[..., None] \
                + weighted_v(pexp, v[:, sl])
            m_i = m_new
        out = acc / torch.clamp_min(l_i, 1e-30).permute(0, 3, 1, 2)[..., None]
    else:
        lg = softcap(logits_block(k), cap)
        lg = _apply_mask(lg, _mask(q_pos, k_pos, window, causal), k_valid)
        out = weighted_v(softmax_f32(lg), v)
    return out.reshape(B, Sq, Hq, Dv).to(q.dtype)
