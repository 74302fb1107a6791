"""Fused paged-attention decode: the CUDA kernel's wrapper and its plain
PyTorch version (port of ``repro/kernels/paged_attention.py`` for dense
pools).

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

What bounds it on the card: the bytes of the K/V pages read,
``2 · ceil((lens + Sq) / ps) · ps · D · itemsize`` per (b, kv head) — at
decode every cached byte is read once.  What the simple design leaves on
the table: a chunk's loads and math do not overlap (no asynchronous copy
ring), the scores run on the FMA pipes, and the grid covers the whole page
table, so chunks past a row's end start only to exit.

Dense (f32 / bf16) pools only; int8/int4 pools with in-loop dequant wait
(ROADMAP: quantized KV pools).  Sq ≤ 8 query tokens per row fold into
the group axis (row ``s·G + g``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import build
from repro_torch.quant.kvcache import kv_mode_of

NEG_INF = -2.0e38                    # finite f32 sentinel (matches mha)
_NO_WINDOW = 2 ** 30                 # "no sliding window" resolves to huge
MAX_SQ = 8
_TILE_TOKENS = 64                    # csrc: tokens per page tile
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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
                     scale: float, cap=None, G: int = 1, bk: int = 128):
    """The reference's blocked lowering (``_paged_attn_blocked``): the same
    page-block online-softmax recurrence over blocks of
    ``max(1, bk // page_size)`` pages, bounded by ``max(lens)``.  Rows whose
    blocks are fully masked contribute exp(NEG_INF − m) == 0."""
    B, S, Hq, D = q.shape
    ps, Hkv = pool_k.shape[1], pool_k.shape[2]
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
        kb = pool_k[pid].to(f32).reshape(B, blk, Hkv, D)
        vb = pool_v[pid].to(f32).reshape(B, blk, Hkv, D)
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
# paged_attn_launch(dtype, q, pool_k, pool_v, pages, lens, out, workspace,
# B, Sq, Hq, Hkv, D, ps, P, G, tile_pages, scale, window, has_cap, cap,
# stream) in csrc/paged_attention.cu.  Pointers and the stream must be
# declared c_void_p: undeclared, ctypes passes a Python int as a 32-bit C
# int.
ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
            _I, _F, _I, _I, _F, _P)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("paged_attention").paged_attn_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _paged_attn_kernel(q, pool_k, pool_v, pages, lens, window: int, *,
                       scale: float, cap, G: int):
    B, S, Hq, D = q.shape
    ps, Hkv = pool_k.shape[1], pool_k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPE_CODE or pool_k.dtype != q.dtype \
            or pool_v.dtype != q.dtype:
        raise TypeError("paged_attn kernel takes float32 or bfloat16 q and "
                        f"pools of one dtype; got {q.dtype}, {pool_k.dtype},"
                        f" {pool_v.dtype}")
    if pages.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("paged_attn kernel takes int32 pages and lens")
    for t in (pool_k, pool_v, pages, lens):
        if t.device != dev:
            raise ValueError("paged_attn: tensors on different devices")
    if pool_v.shape != pool_k.shape or pool_k.shape[3] != D:
        raise ValueError(f"paged_attn: pool shapes {tuple(pool_k.shape)}, "
                         f"{tuple(pool_v.shape)} do not match q head dim {D}")
    if pages.shape[0] != B or lens.shape != (B,):
        raise ValueError("paged_attn: pages (B, P) and lens (B,) must match "
                         "q's batch")
    q, pool_k, pool_v, pages, lens = (
        t.contiguous() for t in (q, pool_k, pool_v, pages, lens))
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
            _DTYPE_CODE[q.dtype], q.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), pages.data_ptr(), lens.data_ptr(),
            out.data_ptr(), ws.data_ptr(), B, S, Hq, Hkv, D, ps, P, G,
            tile_pages, float(scale), int(window), int(cap is not None),
            float(cap or 0.0), stream)
    build.check(err, "paged_attn")
    return out


def paged_attn(q, pool_k, pool_v, pages, lens, *, scale: float,
               window=None, cap=None, kv_of_q=None,
               scale_k=None, scale_v=None) -> torch.Tensor:
    """Fused paged attention over 1..8 query tokens per row.

    q (B, Sq, Hq, D) · pool_k/v (n_pages, ps, Hkv, D) · pages (B, P) ·
    lens (B,) → (B, Sq, Hq, D) in q.dtype.  Query s of row b sits at
    absolute position ``lens[b] + s``; its K/V must already be in the
    pools, and callers keep ``lens[b] + Sq <= P·page_size``.  ``kv_of_q``
    must be the identity or the uniform grouped map (``gqa_group``).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count it in ``paged_attn.launches``) or raise."""
    B, S, Hq, D = q.shape
    Hkv = pool_k.shape[2]
    G = Hq // Hkv if kv_of_q is None else gqa_group(kv_of_q, Hq, Hkv)
    if G is None or Hq != G * Hkv:
        raise ValueError("paged_attn needs an identity or uniform grouped "
                         "kv_of_q map; fall back to the gather path")
    if kv_mode_of(pool_k) != "bf16" or scale_k is not None \
            or scale_v is not None:
        raise NotImplementedError(
            "quantized KV pools are not ported yet (ROADMAP: int8/int4 "
            "pools with in-kernel dequant)")
    if not 1 <= S <= MAX_SQ:
        raise ValueError(f"paged_attn takes 1..{MAX_SQ} query tokens per "
                         f"row, got {S}")
    win = _NO_WINDOW if window is None else int(window)
    if q.device.type == "cpu":
        return paged_attn_plain(q, pool_k, pool_v, pages, lens, win,
                                scale=scale, cap=cap, G=G)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attn: unsupported device {q.device}")
    out = _paged_attn_kernel(q, pool_k, pool_v, pages, lens, win,
                             scale=scale, cap=cap, G=G)
    paged_attn.launches += 1
    return out


paged_attn.launches = 0
