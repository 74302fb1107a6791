"""Fused paged-attention decode: the CUDA kernel's wrapper, its planning
and its plain PyTorch version (port of ``repro/kernels/paged_attention.py``).

Replaces the TPU kernel ``repro/kernels/paged_attention.py:_decode_kernel``
(``paged_attn_pallas``).  The CUDA source is
``repro_torch/csrc/paged_attention.cu``: one launch, grid ``(B, Hkv, CL)``,
one thread-block cluster of ``CL ≤ 8`` blocks per (row b, kv head).

  * ``cluster_size`` fixes CL from the shape and the card, never from
    ``lens``, so the grid does not grow with the page table and a captured
    graph stays valid when ``lens`` changes;
  * block z reads ``lens[b]`` and ``pages[b, :]`` itself (in place of
    scalar prefetch) and takes the run of pages
    ``rank_pages(nb, CL, z, block_pages(ps))`` of the row's
    ``nb = pages_used(lens[b], Sq, ps)``: at least one of the reference's
    K blocks of 128 tokens; a rank with no page adds nothing;
  * each of the block's ``WARPS`` warps takes ``warp_pages`` of the run
    and streams its K pages, then its V pages, through 2-stage
    ``cp.async`` rings (the first two of each load at once); a token's dot
    product is spread over the lanes holding its 16-byte pieces and
    completed by shuffles, so no lane idles at ``Sq·G = 1``;
  * as the reference does per K block, the block takes one max over its
    pages' scores (pass 1) and adds up ``p = exp(s - max)`` and ``p · v``
    (pass 2), warps in warp order; the cluster's blocks meet in rank order
    through distributed shared memory, each rescaled from its max to the
    row's, and the sums are divided by ``max(l, 1e-30)`` and written once:
    no workspace, no second launch, a fixed summation order.

Pools are dense (f32 / bf16, the q dtype), int8, or uint8 holding packed
int4 (``quant.kvcache``); quantized pools come with f32 scale rows
``(n_pages, ps, Hkv)``, copied raw into shared memory and widened on the
way out as ``level * scale`` (``_dequant_block``), so no dense K/V view is
ever built.  A stored row must be a multiple of 16 bytes and at most 512
(``kernel_takes``).

What bounds it on the card: the bytes of the K/V pages read (and their
scale rows), ``2 · nb · ps · (Dp · itemsize + 4)`` per (b, kv head) — at
decode every cached byte is read once, about a microsecond at the main
path's sizes, so the launch and a few dependent loads set its time
(``paged_attn_floor`` times an empty kernel on the same grid and cluster).

Sq ≤ ``MAX_SQ`` query tokens per row fold into the group axis (row
``s·G + g``): speculative verification scores k+1 tokens per row in one
launch.  The reference kernel has no cap; this one is sized for k ≤ 15.
A block's shared memory holds the q rows and the sums of a chunk of the
``Sq·G`` rows: all of them when they fit in 227 KB, else the fewest chunks
that fit (f32 pools at D = 128 and a group of 16, as qwen3-moe's verify
forward at Sq 5 and 9 has, take two), each merged across the cluster and
written before the next; a row's sums do not depend on its chunk.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import build
from .counts import register
from .encoded_matmul import _cdiv, _sm_count
from repro_torch.quant.kvcache import dequantize_kv, kv_mode_of

NEG_INF = -2.0e38                    # finite f32 sentinel (matches mha)
_NO_WINDOW = 2 ** 30                 # "no sliding window" resolves to huge
MAX_SQ = 16
WARPS = 4                            # csrc kWarps: page streams per block
MAX_CLUSTER = 8                      # csrc kMaxCluster: portable size
MAX_ROW_BYTES = 512                  # csrc kMaxPieces x 16 bytes
BLOCKS_PER_SM = 2                    # blocks the cluster size aims for
BLOCK_TOKENS = 128                   # the reference's K block (bk)
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


def cluster_size(B: int, Hkv: int, P: int, sms: int) -> int:
    """Blocks per (row, kv head): enough for about ``BLOCKS_PER_SM`` blocks
    per SM, at most ``MAX_CLUSTER`` and at most one per page of the
    table.  From the shape and the card only, never from ``lens``."""
    return max(1, min(MAX_CLUSTER, P, (BLOCKS_PER_SM * sms) // (B * Hkv)))


def pages_used(length: int, Sq: int, ps: int) -> int:
    """Pages a row reads: through the one holding position
    ``length + Sq - 1`` (at least one, so idle rows stay finite)."""
    return (length + Sq - 1) // ps + 1


def block_pages(ps: int) -> int:
    """Pages of one of the reference's K blocks (``BLOCK_TOKENS`` tokens),
    the least a cluster rank takes."""
    return max(1, BLOCK_TOKENS // ps)


def rank_pages(nb: int, cl: int, z: int, bp: int) -> tuple[int, int]:
    """[begin, end) run of pages of cluster rank ``z`` out of ``cl`` for a
    row of ``nb`` pages: runs of ``max(bp, ceil(nb / cl))`` pages, so a
    row of one reference block stays in rank 0; empty past the row's last
    page."""
    per = max(bp, _cdiv(nb, cl))
    begin = min(nb, z * per)
    return begin, min(nb, begin + per)


def warp_pages(begin: int, end: int, w: int) -> range:
    """Pages of warp ``w`` in a block's run: every ``WARPS``-th one."""
    return range(begin + w, end, WARPS)


def kernel_takes(D: int, mode: str, dtype: torch.dtype) -> bool:
    """Whether the kernel takes head dim D with ``mode`` pools and q of
    ``dtype``: a stored row of 16·k bytes, at most ``MAX_ROW_BYTES``."""
    if mode == "int4":
        row = D // 2 if D % 2 == 0 else 0
    else:
        row = D * (1 if mode == "int8" else torch.finfo(dtype).bits // 8)
    return 0 < row <= MAX_ROW_BYTES and row % 16 == 0


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
        # as the reference's dynamic_slice, a block past the table reads
        # the table's last block; its positions are masked by the query's
        st = max(0, min(j * bp, pages.shape[1] - bp))
        pid = pages[:, st:st + bp]                           # (B, bp)
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
# pages, lens, out, B, Sq, Hq, Hkv, D, ps, P, G, cluster, scale, window,
# has_cap, cap, stream) in csrc/paged_attention.cu.  Pointers and the
# stream must be declared c_void_p: undeclared, ctypes passes a Python int
# as a 32-bit C int.
ARGTYPES = (_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
            _I, _I, _I, _F, _I, _I, _F, _P)
# paged_attn_floor_launch(B, Hkv, cluster, stream)
FLOOR_ARGTYPES = (_I, _I, _I, _P)


@functools.lru_cache(maxsize=None)
def _launcher(name: str = "paged_attn_launch", argtypes=ARGTYPES):
    fn = getattr(build.load("paged_attention"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def paged_attn_floor(B: int, Hkv: int, P: int, device) -> None:
    """Launch an empty kernel on the grid and cluster that ``paged_attn``
    uses for a (B, ·, ·, ·) q, Hkv kv heads and a P-page table: the launch
    floor to time beside the kernel.  Not counted in ``launches``."""
    dev = torch.device(device)
    cl = cluster_size(B, Hkv, P, _sm_count(dev.index or 0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher("paged_attn_floor_launch", FLOOR_ARGTYPES)(
            B, Hkv, cl, stream)
    build.check(err, "paged_attn_floor")


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
    if not kernel_takes(D, mode, q.dtype):
        raise ValueError(f"paged_attn kernel takes stored rows of a multiple "
                         f"of 16 bytes up to {MAX_ROW_BYTES}; head dim {D} "
                         f"with {mode} pools and {q.dtype} q is not one")
    scales = () if mode == "bf16" else (scale_k, scale_v)
    for t in (pool_k, pool_v, pages, lens) + scales:
        if t.device != dev:
            raise ValueError("paged_attn: tensors on different devices")
    q, pool_k, pool_v, pages, lens = (
        t.contiguous() for t in (q, pool_k, pool_v, pages, lens))
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_attn kernel takes 16-byte aligned pools")
    sk_ptr = sv_ptr = None
    if scales:
        scale_k, scale_v = scale_k.contiguous(), scale_v.contiguous()
        sk_ptr, sv_ptr = scale_k.data_ptr(), scale_v.data_ptr()
    out = torch.empty_like(q)
    P = pages.shape[1]
    cl = cluster_size(B, Hkv, P, _sm_count(dev.index or 0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            _DTYPE_CODE[q.dtype], _MODE_CODE[mode], q.data_ptr(),
            pool_k.data_ptr(), pool_v.data_ptr(), sk_ptr, sv_ptr,
            pages.data_ptr(), lens.data_ptr(), out.data_ptr(), B, S, Hq, Hkv,
            D, ps, P, G, cl, float(scale), int(window),
            int(cap is not None), float(cap or 0.0), stream)
    build.check(err, "paged_attn")
    return out


def paged_attn(q, pool_k, pool_v, pages, lens, *, scale: float,
               window=None, cap=None, kv_of_q=None,
               scale_k=None, scale_v=None) -> torch.Tensor:
    """Fused paged attention over 1..``MAX_SQ`` query tokens per row.

    q (B, Sq, Hq, D) · pool_k/v (n_pages, ps, Hkv, Dp) · pages (B, P) ·
    lens (B,) → (B, Sq, Hq, D) in q.dtype.  Query s of row b sits at
    absolute position ``lens[b] + s``; its K/V must already be in the
    pools, and callers keep ``lens[b] + Sq <= P·page_size``.  ``kv_of_q``
    must be the identity or the uniform grouped map (``gqa_group``).
    Quantized pools (int8, or uint8 = packed int4 with Dp = D/2) need
    their ``scale_k``/``scale_v`` (n_pages, ps, Hkv) f32 rows; dense
    pools must not pass them.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count it in ``paged_attn.launches`` and, by Sq, in
    ``paged_attn.sq_launches``) or raise."""
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
    paged_attn.sq_launches[S] += 1
    return out


# launches, and by query tokens per row (Sq) in ``sq_launches``
register(paged_attn, paged_attn_by_sq="sq_launches")
