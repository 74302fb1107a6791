"""Selective SSM (Mamba-1 style): the SSM path of Hymba's hybrid heads
(port of ``repro/nn/ssm.py``).

The reference scans in chunks (an outer ``lax.scan`` over time chunks,
each rematerialized); chunking does not change the arithmetic of a step,
``h = dA·h + dB·x`` then ``y = Σ_n h·C``, so the port runs one loop over
the time steps, the same sums in the same order.  It is plain PyTorch on
every device, as the reference's ``lax.scan`` runs outside any Pallas
kernel.  Decode is one recurrence step with a rolling conv buffer.

The cache of a layer is ``{"conv": (B, K-1, di), "h": (B, di, N)}``;
``ssm_apply`` returns the new one as fresh tensors and never writes the
old one, so a step that runs twice from the same cache (a CUDA graph's
warm-up and capture) computes the same state both times.
"""
from __future__ import annotations

import math

import torch

from .common import act_fn, linear, linear_init

_F32 = torch.float32


def ssm_init(generator, cfg) -> dict:
    """``win`` (d → 2·di), the depthwise conv, ``wbcdt`` (di → dt_rank +
    2N), the f32 ``wdt`` (dt_rank → di), and ``dt_bias``, ``a_log`` and
    ``dskip``, which stay f32 whatever the param dtype; ``wout`` (di →
    d)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N = cfg.ssm_state
    dt_rank = max(1, d // 16)
    p = {}
    p.update(linear_init(generator, d, 2 * di, "win", cfg.mac, False,
                         cfg.pdtype))
    p["conv_w"] = (torch.randn((cfg.ssm_conv, di), generator=generator,
                               dtype=_F32) / math.sqrt(cfg.ssm_conv)
                   ).to(cfg.pdtype)
    p["conv_b"] = torch.zeros((di,), dtype=cfg.pdtype)
    p.update(linear_init(generator, di, dt_rank + 2 * N, "wbcdt", cfg.mac,
                         False, cfg.pdtype))
    p["wdt"] = (torch.randn((dt_rank, di), generator=generator, dtype=_F32)
                / math.sqrt(dt_rank)).to(cfg.pdtype)
    u = torch.rand((di,), generator=generator, dtype=_F32)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    p["dt_bias"] = torch.log(torch.exp(dt0) - 1.0 + 1e-9)
    p["a_log"] = torch.log(torch.arange(1, N + 1, dtype=_F32)
                           .expand(di, N).contiguous())
    p["dskip"] = torch.ones((di,), dtype=_F32)
    p.update(linear_init(generator, di, d, "wout", cfg.mac, False,
                         cfg.pdtype))
    return p


def _conv_causal(x, w, b, init_buf=None):
    """Depthwise causal conv along time: x (B, S, di), w (K, di); the
    taps summed in the reference's order, tap 0 first."""
    K, S = w.shape[0], x.shape[1]
    if init_buf is None:
        pad = torch.nn.functional.pad(x, (0, 0, K - 1, 0))
    else:
        pad = torch.cat([init_buf, x], 1)
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out + b


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(p, xc, cfg):
    """The step inputs of the scan: dt (…, di), B and C (…, N), all f32;
    ``dA = exp(dt·A)`` and ``dB·x = dt·B·x`` are formed per step
    (``_step``), elementwise as the reference forms them in bulk."""
    N = cfg.ssm_state
    dt_rank = p["wdt"].shape[0]
    bcdt = linear(p, "wbcdt", xc, cfg.mac, cfg.cdtype)
    dt_lr = bcdt[..., :dt_rank]
    Bm = bcdt[..., dt_rank:dt_rank + N].to(_F32)
    Cm = bcdt[..., dt_rank + N:].to(_F32)
    # wdt is a plain f32 product outside ``linear``: fp in every MAC mode
    dt = _softplus(torch.matmul(dt_lr.to(_F32), p["wdt"].to(_F32))
                   + p["dt_bias"])
    return dt, Bm, Cm


def _step(h, A, dt_t, b_t, c_t, x_t):
    """One recurrence step: ``h = exp(dt·A)·h + dt·B·x``, ``y = Σ_n h·C``
    (the reference's ``einsum("bdn,bn->bd")``)."""
    dA = torch.exp(dt_t[..., None] * A)
    dBx = dt_t[..., None] * b_t[..., None, :] * x_t[..., None]
    h = dA * h + dBx
    return h, torch.einsum("bdn,bn->bd", h, c_t)


def ssm_scan(p, xc, cfg, h0=None):
    """Selective scan over xc (B, S, di), the conv + activation output:
    (y (B, S, di) f32, h_final (B, di, N))."""
    B, S, di = xc.shape
    dt, Bm, Cm = _ssm_params(p, xc, cfg)
    A = -torch.exp(p["a_log"])                       # (di, N)
    xf = xc.to(_F32)
    h = h0 if h0 is not None else torch.zeros(
        (B, di, cfg.ssm_state), dtype=_F32, device=xc.device)
    ys = []
    for t in range(S):
        h, y_t = _step(h, A, dt[:, t], Bm[:, t], Cm[:, t], xf[:, t])
        ys.append(y_t)
    y = torch.stack(ys, 1)
    return y + xf * p["dskip"], h


def ssm_apply(p: dict, x: torch.Tensor, cfg, *, cache=None) -> tuple:
    """The Mamba path: in-projection → conv → SSM → gate → out-projection.

    ``cache``: None (training, or a cacheless forward: the state is
    dropped) or ``{conv (B, K-1, di), h (B, di, N)}``; a call of S > 1
    tokens scans from it (prefill), a call of one token takes one step
    (decode).  Returns (out (B, S, d), new cache or None)."""
    h_in = linear(p, "win", x, cfg.mac, cfg.cdtype)
    xi, z = torch.chunk(h_in, 2, dim=-1)
    silu = act_fn("silu")
    w, b = p["conv_w"].to(_F32), p["conv_b"].to(_F32)
    if cache is None:
        xc = silu(_conv_causal(xi, w, b))
        y, _ = ssm_scan(p, xc, cfg)
        new_cache = None
    else:
        K = p["conv_w"].shape[0]
        conv = cache["conv"]
        buf = torch.cat([conv, xi.to(conv.dtype)], 1)
        xc = silu(_conv_causal(xi, w, b, init_buf=conv))
        if x.shape[1] > 1:                          # prefill: the scan
            y, h = ssm_scan(p, xc, cfg, h0=cache["h"])
        else:                                       # decode: one step
            dt, Bm, Cm = _ssm_params(p, xc, cfg)
            A = -torch.exp(p["a_log"])
            xf = xc.to(_F32)
            h, y_t = _step(cache["h"], A, dt[:, 0], Bm[:, 0], Cm[:, 0],
                           xf[:, 0])
            y = y_t[:, None] + xf * p["dskip"]
        new_cache = {"conv": buf[:, buf.shape[1] - (K - 1):], "h": h}
    out = (y * silu(z.to(_F32))).to(cfg.cdtype)
    return linear(p, "wout", out, cfg.mac, cfg.cdtype), new_cache


def init_ssm_cache(cfg, batch: int, n_layers: int, *, device) -> list:
    """Per layer ``{conv (batch, K-1, di) in the compute dtype, h (batch,
    di, N) f32}`` of zeros (the reference stacks them ``(L, …)``)."""
    di = cfg.ssm_expand * cfg.d_model
    return [{"conv": torch.zeros((batch, cfg.ssm_conv - 1, di),
                                 dtype=cfg.cdtype, device=device),
             "h": torch.zeros((batch, di, cfg.ssm_state), dtype=_F32,
                              device=device)}
            for _ in range(n_layers)]
