"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, a sequential scan with a head-block-diagonal recurrence)
(port of ``repro/nn/xlstm.py``).

mLSTM chunkwise (stabilized exponential gating):
  carry (C (B,H,dk,dv), n (B,H,dk), m (B,H)); per chunk with the
  inclusive log-forget cumsum b_j and g_j = ĩ_j − b_j, M_i = max(m₀,
  cummax g),
    intra weight  exp(g_j − M_i) · (qᵢ·kⱼ)   (j ≤ i)
    inter weight  exp(m₀ − M_i) · (C₀ᵀ qᵢ)
    h_i = num_i / max(|den_i|, exp(−(b_i + M_i)))
  the chunk-exit state uses M_end = max(m₀, max_j g_j).

Plain PyTorch on every device: the reference has no Pallas kernel for
either cell (its projections go through ``linear``, so kernel 1 where the
MAC mode is encoded).  A cached call returns the new state as fresh
tensors and never writes the old one, so a step that runs twice from the
same cache (a CUDA graph's warm-up and capture) computes the same state
both times.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import act_fn, linear, linear_init, norm_apply, norm_init
from .ssm import _conv_causal

_F32 = torch.float32
# the stabilizer state m of a fresh cache (the reference's -1e30)
M_INIT = -1e30
# the mLSTM's causal conv width (fixed in the reference)
CONV_K = 4


# --------------------------------- mLSTM -----------------------------------

def mlstm_init(generator, cfg) -> dict:
    """``wi`` (d → 2·di), the depthwise conv, the per-head block-diagonal
    ``bq/bk/bv (H, dh, dh)``, the f32 gate projections ``wig/wfg (di, H)``
    and biases, the per-head norm and ``wo`` (di → d)."""
    d = cfg.d_model
    di = int(cfg.mlstm_proj_factor * d)
    H = cfg.n_heads
    dh = di // H
    p = {}
    p.update(linear_init(generator, d, 2 * di, "wi", cfg.mac, False,
                         cfg.pdtype))
    p["conv_w"] = (torch.randn((CONV_K, di), generator=generator,
                               dtype=_F32) * 0.3).to(cfg.pdtype)
    p["conv_b"] = torch.zeros((di,), dtype=cfg.pdtype)
    for nm in ("bq", "bk", "bv"):
        p[nm] = (torch.randn((H, dh, dh), generator=generator, dtype=_F32)
                 / math.sqrt(dh)).to(cfg.pdtype)
    p["wig"] = torch.randn((di, H), generator=generator, dtype=_F32) * 0.01
    p["big"] = torch.full((H,), -3.0, dtype=_F32)
    p["wfg"] = torch.randn((di, H), generator=generator, dtype=_F32) * 0.01
    p["bfg"] = torch.linspace(3.0, 6.0, H, dtype=_F32)
    p.update(norm_init(dh, "rms", cfg.pdtype, "hnorm"))
    p.update(linear_init(generator, di, d, "wo", cfg.mac, False, cfg.pdtype))
    return p


def _mlstm_qkvif(p, x, cfg, conv_buf=None):
    """q, k, v (B,S,H,dh) in the compute dtype, the raw input gate and
    log-sigmoid forget gate (B,S,H) f32, the output gate's pre-activation
    z (B,S,di), and the conv buffer's next state (None without one)."""
    B, S, _ = x.shape
    di = p["conv_w"].shape[1]
    H = cfg.n_heads
    dh = di // H
    cdt = cfg.cdtype
    h = linear(p, "wi", x, cfg.mac, cdt)
    xi, z = torch.chunk(h, 2, dim=-1)
    xc = act_fn("silu")(_conv_causal(xi, p["conv_w"].to(_F32),
                                     p["conv_b"].to(_F32),
                                     init_buf=conv_buf))
    new_buf = None
    if conv_buf is not None:
        buf = torch.cat([conv_buf, xi.to(conv_buf.dtype)], 1)
        new_buf = buf[:, buf.shape[1] - (CONV_K - 1):]
    xc = xc.to(cdt)
    xh = xc.reshape(B, S, H, dh)
    q = torch.einsum("bshd,hde->bshe", xh, p["bq"].to(cdt))
    k = torch.einsum("bshd,hde->bshe", xh, p["bk"].to(cdt)) \
        / math.sqrt(dh)
    v = torch.einsum("bshd,hde->bshe", xi.reshape(B, S, H, dh),
                     p["bv"].to(cdt))
    xcf = xc.to(_F32)
    ig = torch.einsum("bsd,dh->bsh", xcf, p["wig"]) + p["big"]
    fg = F.logsigmoid(torch.einsum("bsd,dh->bsh", xcf, p["wfg"]) + p["bfg"])
    return q, k, v, ig, fg, z, new_buf


def mlstm_step(carry, qkvif):
    """The exact one-step recurrence (decode, and the tests' oracle).

    carry: (C (B,H,dk,dv), n (B,H,dk), m (B,H)); qkvif: q, k, v (B,H,dh)
    and ig, fg (B,H) of one time step.  Returns (new carry, h (B,H,dv))."""
    C, n, m = carry
    q, k, v, ig, fg = qkvif
    qf, kf, vf = (a.to(_F32) for a in (q, k, v))
    m_new = torch.maximum(fg + m, ig)
    fs = torch.exp(fg + m - m_new)[..., None]
    is_ = torch.exp(ig - m_new)[..., None]
    C = fs[..., None] * C + is_[..., None] * kf[..., :, None] \
        * vf[..., None, :]
    n = fs * n + is_ * kf
    num = torch.einsum("bhkv,bhk->bhv", C, qf)
    den = torch.abs(torch.einsum("bhk,bhk->bh", n, qf))
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    return (C, n, m_new), num / den


def init_mlstm_state(B, H, dh, device):
    """A fresh carry: C and n zeros, m at ``M_INIT``."""
    return (torch.zeros((B, H, dh, dh), dtype=_F32, device=device),
            torch.zeros((B, H, dh), dtype=_F32, device=device),
            torch.full((B, H), M_INIT, dtype=_F32, device=device))


def _mlstm_chunk(state, qc, kc, vc, igc, fgc):
    """One chunk (B,L,H,·) from ``state``: (new state, h (B,L,H,dh))."""
    C0, n0, m0 = state
    L = qc.shape[1]
    qf, kf, vf = qc.to(_F32), kc.to(_F32), vc.to(_F32)
    b = torch.cumsum(fgc, dim=1)                      # (B,L,H) inclusive
    g = igc - b
    M = torch.maximum(m0[:, None], torch.cummax(g, dim=1).values)
    m_i = b + M
    # intra: w_ij = q_i·k_j · exp(g_j − M_i), j ≤ i
    scores = torch.einsum("blhd,bjhd->bhlj", qf, kf)
    decay = torch.exp(g.permute(0, 2, 1)[:, :, None, :]
                      - M.permute(0, 2, 1)[:, :, :, None])
    causal = torch.ones((L, L), dtype=torch.bool, device=qc.device).tril()
    wmat = torch.where(causal[None, None], scores * decay,
                       torch.zeros((), dtype=_F32, device=qc.device))
    num = torch.einsum("bhlj,bjhd->blhd", wmat, vf)
    den = torch.einsum("bhlj->blh", wmat)
    # inter: exp(m0 − M_i)
    inter_w = torch.exp(m0[:, None] - M)              # (B,L,H)
    num = num + inter_w[..., None] * torch.einsum("bhkv,blhk->blhv", C0, qf)
    den = den + inter_w * torch.einsum("bhk,blhk->blh", n0, qf)
    h = num / torch.maximum(torch.abs(den), torch.exp(-m_i))[..., None]
    # the chunk-exit state
    M_end = torch.maximum(m0, g.amax(dim=1))          # (B,H)
    w_end = torch.exp(g - M_end[:, None])             # (B,L,H)
    decay0 = torch.exp(m0 - M_end)
    C1 = decay0[..., None, None] * C0 \
        + torch.einsum("blh,blhk,blhv->bhkv", w_end, kf, vf)
    n1 = decay0[..., None] * n0 + torch.einsum("blh,blhk->bhk", w_end, kf)
    m1 = b[:, -1] + M_end
    return (C1, n1, m1), h


def mlstm_chunkwise(q, k, v, ig, fg, carry=None, chunk: int = 256):
    """Chunkwise-parallel mLSTM: q, k, v (B,S,H,dh); ig, fg (B,S,H) raw
    gates.  The chunk is ``min(chunk, S)``, or all of S where that does
    not divide it, as in the reference.  Returns (h (B,S,H,dh) f32, carry).
    """
    B, S, H, dh = q.shape
    if carry is None:
        carry = init_mlstm_state(B, H, dh, q.device)
    L = min(chunk, S)
    if S % L:
        L = S
    hs = []
    for c0 in range(0, S, L):
        sl = slice(c0, c0 + L)
        carry, h = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                ig[:, sl], fg[:, sl])
        hs.append(h)
    return torch.cat(hs, 1), carry


def mlstm_apply(p: dict, x: torch.Tensor, cfg, *, cache=None) -> tuple:
    """The mLSTM cell over x (B, S, d) → (out (B, S, d), new cache).

    ``cache``: None (the state is dropped) or ``{C, n, m, conv}``
    (``init_mlstm_cache``): one token takes ``mlstm_step``, more run
    chunkwise from the carry; the new cache is fresh tensors."""
    B, S, _ = x.shape
    H = cfg.n_heads
    conv_buf = None if cache is None else cache["conv"]
    q, k, v, ig, fg, z, new_buf = _mlstm_qkvif(p, x, cfg, conv_buf)
    if cache is None:
        h, _ = mlstm_chunkwise(q, k, v, ig, fg, chunk=cfg.chunk_size)
        new_cache = None
    else:
        st = (cache["C"], cache["n"], cache["m"])
        if S == 1:
            st, h1 = mlstm_step(st, (q[:, 0], k[:, 0], v[:, 0], ig[:, 0],
                                     fg[:, 0]))
            h = h1[:, None]
        else:
            h, st = mlstm_chunkwise(q, k, v, ig, fg, carry=st,
                                    chunk=cfg.chunk_size)
        new_cache = {"C": st[0], "n": st[1], "m": st[2], "conv": new_buf}
    h = norm_apply(p, h.to(cfg.cdtype), "rms", cfg.norm_eps, "hnorm")
    out = h.reshape(B, S, H * h.shape[-1]) \
        * F.silu(z.to(_F32)).to(cfg.cdtype)
    return linear(p, "wo", out, cfg.mac, cfg.cdtype), new_cache


# --------------------------------- sLSTM -----------------------------------

def slstm_init(generator, cfg) -> dict:
    """``wi`` (d → 4d: the i, f, z, o pre-activations), the recurrence
    ``rec (4, H, dh, dh)``, the f32 gate biases, the norm, and the gated
    FFN ``wup`` (d → 2·ff) and ``wo`` (ff → d), ff = int(4d / 3)."""
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    p = {}
    p.update(linear_init(generator, d, 4 * d, "wi", cfg.mac, False,
                         cfg.pdtype))
    p["rec"] = (torch.randn((4, H, dh, dh), generator=generator, dtype=_F32)
                / math.sqrt(dh)).to(cfg.pdtype)
    p["bias"] = torch.cat([torch.full((d,), -3.0),
                           torch.linspace(3.0, 6.0, d),
                           torch.zeros((2 * d,))]).to(_F32)
    p.update(norm_init(d, "rms", cfg.pdtype, "hnorm"))
    ff = int(4 * d / 3)
    p.update(linear_init(generator, d, 2 * ff, "wup", cfg.mac, False,
                         cfg.pdtype))
    p.update(linear_init(generator, ff, d, "wo", cfg.mac, False, cfg.pdtype))
    return p


def init_slstm_state(B, d, device):
    """A fresh (h, c, m, n): zeros, m at ``M_INIT``."""
    z = torch.zeros((B, d), dtype=_F32, device=device)
    return (z, z.clone(), torch.full((B, d), M_INIT, dtype=_F32,
                                     device=device), z.clone())


def _slstm_step(st, z_t, rec, bias, H):
    h, c, m, n = st
    B, d = h.shape
    hh = h.reshape(B, H, d // H)
    r = torch.einsum("ghde,bhd->gbhe", rec, hh).reshape(4, B, d)
    z4 = z_t.to(_F32).reshape(B, 4, d).permute(1, 0, 2)
    pre = z4 + r + bias.reshape(4, d)[:, None]
    ig, fg, zg, og = pre[0], pre[1], pre[2], pre[3]
    fg = F.logsigmoid(fg)
    m_new = torch.maximum(fg + m, ig)
    i_ = torch.exp(ig - m_new)
    f_ = torch.exp(fg + m - m_new)
    c = f_ * c + i_ * torch.tanh(zg)
    n = f_ * n + i_
    h = torch.sigmoid(og) * c / torch.clamp_min(n, 1e-6)
    return h, c, m_new, n


def slstm_apply(p: dict, x: torch.Tensor, cfg, *, cache=None) -> tuple:
    """The sLSTM over S, one step at a time, then the gated
    post-up-projection FFN: x (B, S, d) → (out (B, S, d), new cache).

    ``cache``: None or ``{h, c, m, n}`` (``init_slstm_cache``); the new
    cache is fresh tensors."""
    B, S, d = x.shape
    zs = linear(p, "wi", x, cfg.mac, cfg.cdtype)       # (B,S,4d)
    rec = p["rec"].to(_F32)
    if cache is None:
        st = init_slstm_state(B, d, x.device)
    else:
        st = (cache["h"], cache["c"], cache["m"], cache["n"])
    hs = []
    for t in range(S):
        st = _slstm_step(st, zs[:, t], rec, p["bias"], cfg.n_heads)
        hs.append(st[0])
    h = torch.stack(hs, 1).to(cfg.cdtype)              # (B,S,d)
    new_cache = None
    if cache is not None:
        new_cache = dict(zip(("h", "c", "m", "n"), st))
    h = norm_apply(p, h, "rms", cfg.norm_eps, "hnorm")
    up = linear(p, "wup", h, cfg.mac, cfg.cdtype)
    a, b = torch.chunk(up, 2, dim=-1)
    return linear(p, "wo", act_fn("gelu")(a) * b, cfg.mac, cfg.cdtype), \
        new_cache


# --------------------------------- caches ----------------------------------

def init_mlstm_cache(cfg, batch: int, n_layers: int, *, device) -> list:
    """Per layer ``{C (batch, H, dh, dh), n (batch, H, dh), m (batch, H)}``
    f32 (m at ``M_INIT``) and the conv buffer ``conv (batch, 3, di)`` in
    the compute dtype (the reference stacks them ``(L, …)``)."""
    di = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    out = []
    for _ in range(n_layers):
        C, n, m = init_mlstm_state(batch, H, di // H, device)
        out.append({"C": C, "n": n, "m": m,
                    "conv": torch.zeros((batch, CONV_K - 1, di),
                                        dtype=cfg.cdtype, device=device)})
    return out


def init_slstm_cache(cfg, batch: int, n_layers: int, *, device) -> list:
    """Per layer ``{h, c, m, n}`` (batch, d) f32, m at ``M_INIT``."""
    return [dict(zip(("h", "c", "m", "n"),
                     init_slstm_state(batch, cfg.d_model, device)))
            for _ in range(n_layers)]
