"""Fused paged-attention decode: the CUDA kernel's wrapper and its plain
PyTorch version (port of ``repro/kernels/paged_attention.py``).

Replaces the TPU kernel ``repro/kernels/paged_attention.py:_decode_kernel``
(``paged_attn_pallas``).  The CUDA source is
``repro_torch/csrc/paged_attention.cu``.  The page chain of a row, up to
the page holding position ``lens[b] + Sq - 1``, is cut into chunks of
whole pages (about 64 tokens); one block per (row b, kv head, chunk) reads
``pages[b, :]`` and ``lens[b]`` itself (in place of scalar prefetch) and
writes its chunk's softmax statistics (m, l) and unnormalised sums for the
head's Sq·G query rows, in f32; a second pass rescales the chunks to their
common max in chunk order and divides.  The TPU kernel's sequential walk
over page blocks thus runs in parallel, so 4 slots fill the card.

Pools are dense (f32 / bf16, the q dtype), int8, or uint8 holding packed
int4 (``quant.kvcache``); quantized pools come with f32 scale rows
``(n_pages, ps, Hkv)`` and are widened inside the page loop as
``level * scale`` (``_dequant_block``), so no dense K/V view is ever built.

What bounds it on the card: the bytes of the K/V pages read (and their
scale rows), ``2 · ceil((lens + Sq) / ps) · ps · (Dp · itemsize + 4)``
per (b, kv head) — at decode every cached byte is read once.  What the
simple design leaves on the table: a chunk's loads and math do not overlap
(no asynchronous copy ring), the scores run on the FMA pipes, and the grid
covers the whole page table, so chunks past a row's end start only to
exit.

Sq ≤ 8 query tokens per row fold into the group axis (row ``s·G + g``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import build
from repro_torch.quant.kvcache import dequantize_kv, kv_mode_of

NEG_INF = -2.0e38                    # finite f32 sentinel (matches mha)
_NO_WINDOW = 2 ** 30                 # "no sliding window" resolves to huge
MAX_SQ = 8
_TILE_TOKENS = 64                    # csrc: tokens per page tile
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MODE_CODE = {"bf16": 0, "int8": 1, "int4": 2}     # csrc: kv_mode


def _dequant_block(x, scale, mode):
    """Pool bytes ``x (..., H, Dp)`` + scale rows ``(..., H)`` → f32
    ``(..., H, D)``; ``mode == 'bf16'`` is the dense passthrough."""
    if mode == "bf16":
        return x.to(torch.float32)
    return dequantize_kv(x, scale, mode)


def gqa_group(kv_of_q, n_q: int, n_kv: int) -> Optional[int]:
    """Group size G when ``kv_of_q`` is the identity (MHA) or the uniform
    grouped map (GQA/MQA); ``None`` for irregular maps (callers fall back
    to the gather path)."""
    kv_np = np.asarray(kv_of_q)
    if n_kv == n_q and np.array_equal(kv_np, np.arange(n_q)):
        return 1
    group = n_q // n_kv if n_kv and n_q % n_kv == 0 else 0
    if group > 1 and np.array_equal(
            kv_np, np.minimum(np.arange(n_q) // group, n_kv - 1)):
        return group
    return None


def _softcap(s, cap):
    return s if cap is None else cap * torch.tanh(s / cap)


def paged_attn_plain(q, pool_k, pool_v, pages, lens, window: int, *,
                     scale: float, cap=None, G: int = 1, bk: int = 128,
                     scale_k=None, scale_v=None):
    """The reference's blocked lowering (``_paged_attn_blocked``): the same
    page-block online-softmax recurrence over blocks of
    ``max(1, bk // page_size)`` pages, bounded by ``max(lens)``, with
    quantized pools widened per block.  Rows whose blocks are fully masked
    contribute exp(NEG_INF − m) == 0."""
    B, S, Hq, D = q.shape
    ps, Hkv = pool_k.shape[1], pool_k.shape[2]
    mode = kv_mode_of(pool_k)
    f32 = torch.float32
    dev = q.device
    qg = (q * torch.tensor(scale, dtype=q.dtype, device=dev)
          ).reshape(B, S, Hkv, G, D).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(B, Hkv, S * G, D).to(f32)
    bp = max(1, bk // ps)
    blk = bp * ps
    pages = pages.long()
    P = pages.shape[1]
    if P % bp:                                       # pad table → scratch
        pages = torch.nn.functional.pad(pages, (0, bp - P % bp))
    lens = lens.long()
    nb = (int(lens.max()) + S - 1) // blk + 1
    t0 = torch.arange(blk, device=dev)
    rq = torch.arange(S * G, device=dev) // G
    m = torch.full((B, Hkv, S * G), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros((B, Hkv, S * G), dtype=f32, device=dev)
    acc = torch.zeros((B, Hkv, S * G, D), dtype=f32, device=dev)
    for j in range(nb):
        pid = pages[:, j * bp:(j + 1) * bp]                  # (B, bp)
        skb = None if scale_k is None else scale_k[pid]
        svb = None if scale_v is None else scale_v[pid]
        kb = _dequant_block(pool_k[pid], skb, mode).reshape(B, blk, Hkv, D)
        vb = _dequant_block(pool_v[pid], svb, mode).reshape(B, blk, Hkv, D)
        s = torch.einsum("bhgd,bphd->bhgp", qg, kb)
        s = _softcap(s, cap)
        d = (lens[:, None, None] + rq[None, :, None]
             - (j * blk + t0)[None, None, :])
        ok = (d >= 0) & (d < window)
        s = torch.where(ok[:, None], s, torch.tensor(NEG_INF, dtype=f32,
                                                     device=dev))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgp,bphd->bhgd",
                                                    pexp, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.reshape(B, Hkv, S, G, D).permute(0, 2, 1, 3, 4)
    return out.reshape(B, S, Hq, D).to(q.dtype)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# paged_attn_launch(dtype, kv_mode, q, pool_k, pool_v, scale_k, scale_v,
# pages, lens, out, workspace, B, Sq, Hq, Hkv, D, ps, P, G, tile_pages,
# scale, window, has_cap, cap, stream) in csrc/paged_attention.cu.
# Pointers and the stream must be declared c_void_p: undeclared, ctypes
# passes a Python int as a 32-bit C int.
ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            _I, _I, _I, _I, _F, _I, _I, _F, _P)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("paged_attention").paged_attn_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _paged_attn_kernel(q, pool_k, pool_v, pages, lens, window: int, *,
                       scale: float, cap, G: int, scale_k=None,
                       scale_v=None):
    B, S, Hq, D = q.shape
    ps, Hkv = pool_k.shape[1], pool_k.shape[2]
    dev = q.device
    mode = kv_mode_of(pool_k)
    if q.dtype not in _DTYPE_CODE or pool_v.dtype != pool_k.dtype or (
            mode == "bf16" and pool_k.dtype != q.dtype):
        raise TypeError("paged_attn kernel takes float32 or bfloat16 q with "
                        "pools of q's dtype, int8 or uint8 (packed int4); "
                        f"got {q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    if pages.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged_attn kernel takes int32 pages and lens")
    Dp = D // 2 if mode == "int4" else D
    if pool_v.shape != pool_k.shape or pool_k.shape[3] != Dp or (
            mode == "int4" and D % 2):
        raise ValueError(f"paged_attn: pool shapes {tuple(pool_k.shape)}, "
                         f"{tuple(pool_v.shape)} do not match q head dim {D}"
                         f" ({mode} pools)")
    if mode != "bf16":
        for t in (scale_k, scale_v):
            if t.dtype != torch.float32 or t.shape != pool_k.shape[:3]:
                raise ValueError("paged_attn: scale rows must be float32 "
                                 f"{tuple(pool_k.shape[:3])}")
    if pages.shape[0] != B or lens.shape != (B,):
        raise ValueError("paged_attn: pages (B, P) and lens (B,) must match "
                         "q's batch")
    scales = () if mode == "bf16" else (scale_k, scale_v)
    for t in (pool_k, pool_v, pages, lens) + scales:
        if t.device != dev:
            raise ValueError("paged_attn: tensors on different devices")
    q, pool_k, pool_v, pages, lens = (
        t.contiguous() for t in (q, pool_k, pool_v, pages, lens))
    sk_ptr = sv_ptr = None
    if scales:
        scale_k, scale_v = scale_k.contiguous(), scale_v.contiguous()
        sk_ptr, sv_ptr = scale_k.data_ptr(), scale_v.data_ptr()
    out = torch.empty_like(q)
    P = pages.shape[1]
    tile_pages = max(1, _TILE_TOKENS // ps)
    # per (row, kv head, chunk of tile_pages pages): acc (S·G, D), then
    # (m, l) (S·G, 2)
    n_chunks = -(-P // tile_pages)
    ws = torch.empty(B * Hkv * n_chunks * S * G * (D + 2),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            _DTYPE_CODE[q.dtype], _MODE_CODE[mode], q.data_ptr(),
            pool_k.data_ptr(), pool_v.data_ptr(), sk_ptr, sv_ptr,
            pages.data_ptr(), lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
            B, S, Hq, Hkv, D, ps, P, G, tile_pages, float(scale),
            int(window), int(cap is not None), float(cap or 0.0), stream)
    build.check(err, "paged_attn")
    return out


def paged_attn(q, pool_k, pool_v, pages, lens, *, scale: float,
               window=None, cap=None, kv_of_q=None,
               scale_k=None, scale_v=None) -> torch.Tensor:
    """Fused paged attention over 1..8 query tokens per row.

    q (B, Sq, Hq, D) · pool_k/v (n_pages, ps, Hkv, Dp) · pages (B, P) ·
    lens (B,) → (B, Sq, Hq, D) in q.dtype.  Query s of row b sits at
    absolute position ``lens[b] + s``; its K/V must already be in the
    pools, and callers keep ``lens[b] + Sq <= P·page_size``.  ``kv_of_q``
    must be the identity or the uniform grouped map (``gqa_group``).
    Quantized pools (int8, or uint8 = packed int4 with Dp = D/2) need
    their ``scale_k``/``scale_v`` (n_pages, ps, Hkv) f32 rows; dense
    pools must not pass them.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count it in ``paged_attn.launches``) or raise."""
    B, S, Hq, D = q.shape
    Hkv = pool_k.shape[2]
    G = Hq // Hkv if kv_of_q is None else gqa_group(kv_of_q, Hq, Hkv)
    if G is None or Hq != G * Hkv:
        raise ValueError("paged_attn needs an identity or uniform grouped "
                         "kv_of_q map; fall back to the gather path")
    if (kv_mode_of(pool_k) != "bf16") != (scale_k is not None) or \
            (scale_k is None) != (scale_v is None):
        raise ValueError("quantized pools need scale_k/scale_v rows "
                         "(and dense pools must not pass them)")
    if not 1 <= S <= MAX_SQ:
        raise ValueError(f"paged_attn takes 1..{MAX_SQ} query tokens per "
                         f"row, got {S}")
    win = _NO_WINDOW if window is None else int(window)
    if q.device.type == "cpu":
        return paged_attn_plain(q, pool_k, pool_v, pages, lens, win,
                                scale=scale, cap=cap, G=G, scale_k=scale_k,
                                scale_v=scale_v)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attn: unsupported device {q.device}")
    out = _paged_attn_kernel(q, pool_k, pool_v, pages, lens, win,
                             scale=scale, cap=cap, G=G, scale_k=scale_k,
                             scale_v=scale_v)
    paged_attn.launches += 1
    return out


paged_attn.launches = 0
