"""Causal flash-attention forward: the CUDA kernels' wrapper and its plain
PyTorch version (port of ``repro/kernels/flash_attention.py``).

Replaces the TPU kernel ``repro/kernels/flash_attention.py:_kernel``
(``flash_attention``).  The CUDA source is
``repro_torch/csrc/flash_attention.cu``, with three kernels that
``flash_route`` chooses between by dtype and head dim before the launch:

  * ``"mma"``, bf16 with D in ``MMA_HEAD_DIMS``: FlashAttention-2 style on
    the tensor cores.  One block of 4 warps per (b·h, tile of 64 query
    rows); each warp keeps 16 rows' q fragments, scores, (m, l) and f32
    output sums in registers; K/V tiles of 64 keys stream through a
    2-stage ``cp.async`` ring; ``Q·Kᵀ`` and ``P·V`` are ``mma.sync``
    bf16 products with f32 sums.  At the prefill shapes bytes and bf16
    tensor-core operations bound it about equally;
  * ``"tf32x3"``, f32 with D in ``TF32X3_HEAD_DIMS``: the same layout in
    f32, each product split into three ``mma.sync.m16n8k8`` tf32 products
    (``split_tf32``: ``x = hi + lo``; ``lo·hi + hi·lo + hi·hi``), which
    keeps about f32 accuracy on the tensor cores.  P's A fragment takes
    each 8-key step's keys in the order ``P_KEY_OF_SLOT``.  Bound by the
    operations, ``3 · 4 · D`` tf32 per (query, visible key) pair;
  * ``"fma"``, bf16 and f32 with other D: the block keeps the tile's
    (m, l) and f32 output sums in shared memory and runs both products on
    the FMA pipes; bound by the operations, ``4 · Sq · Sk_visible · D``
    per head.

Both loop over 64-key tiles, the TPU grid's sequential K axis, from the
first key tile inside the window and, when causal, to the last tile the
tile's last row can see; the reference runs the masked tiles too, which
changes nothing (see the source).  GQA reads kv head ``h // G`` directly
in place of the reference's repeated K/V.

Numerics follow the reference: ``s = (q · kᵀ) * scale`` accumulated in
f32, softcap ``cap·tanh(s/cap)``, the causal and window masks to the
finite ``NEG_INF``, ``(m, l, acc)`` in f32, ``p`` rounded to v's dtype
before P·V (``l`` sums the unrounded ``p``), and ``acc / max(l, 1e-30)``
in q's dtype.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .counts import register

NEG_INF = -2.0e38
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 128                                        # csrc: head dim bound
MMA_HEAD_DIMS = tuple(range(16, MAX_D + 1, 16))    # csrc: launch_mma_d
TF32X3_HEAD_DIMS = tuple(range(8, MAX_D + 1, 8))   # csrc: launch_tf32x3_d
_ROUTE_CODE = {"fma": 0, "mma": 1, "tf32x3": 2}
# csrc flash_fwd_tf32x3_kernel: the key of an 8-key step that k-slot t of
# P's m16n8k8 A fragment holds.  The S accumulator gives a thread keys 2t
# and 2t + 1 of the step; they serve as k-slots t and t + 4, and V's B
# fragment reads rows 2t and 2t + 1 to match.
P_KEY_OF_SLOT = (0, 2, 4, 6, 1, 3, 5, 7)


def split_tf32(x: torch.Tensor):
    """f32 ``x`` → (hi, lo), each rounded to tf32 (10 mantissa bits) to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` (add
    ``0x1000`` to the bits, clear the low 13); ``x = hi + lo`` to about
    2^-22 relative.  The kernel's split, in torch."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def _softcap(s, cap):
    return s if cap is None else cap * torch.tanh(s / cap)


def flash_attention_plain(q, k, v, *, scale: float = 1.0, causal: bool = True,
                          window=None, cap=None, bq: int = 128,
                          bk: int = 128, G: int = 1):
    """The reference kernel's recurrence over ``bq × bk`` tiles.

    q (BH, Sq, D); k, v (BH // G, Sk, D), query head ``i`` reading kv head
    ``i // G`` → (BH, Sq, D) in q's dtype.  Sq and Sk must be multiples of
    bq and bk (``ops.flash_mha`` pads)."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    if Sq % bq or Sk % bk:
        raise ValueError(f"flash_attention_plain: Sq {Sq} and Sk {Sk} must "
                         f"be multiples of bq {bq} and bk {bk}")
    if G > 1:
        k = k.repeat_interleave(G, dim=0)
        v = v.repeat_interleave(G, dim=0)
    f32 = torch.float32
    dev = q.device
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    out = torch.empty_like(q)
    for i in range(Sq // bq):
        qt = q[:, i * bq:(i + 1) * bq].to(f32)
        m = torch.full((BH, bq, 1), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((BH, bq, 1), dtype=f32, device=dev)
        acc = torch.zeros((BH, bq, D), dtype=f32, device=dev)
        q_pos = i * bq + torch.arange(bq, device=dev)[:, None]
        for j in range(Sk // bk):
            kt = k[:, j * bk:(j + 1) * bk]
            vt = v[:, j * bk:(j + 1) * bk]
            s = torch.matmul(qt, kt.to(f32).transpose(1, 2)) * scale
            s = _softcap(s, cap)
            k_pos = j * bk + torch.arange(bk, device=dev)[None, :]
            ok = torch.ones((bq, bk), dtype=torch.bool, device=dev)
            if causal:
                ok = ok & (q_pos >= k_pos)
            if window is not None:
                ok = ok & ((q_pos - k_pos) < window)
            s = torch.where(ok, s, neg)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.matmul(p.to(v.dtype).to(f32),
                                             vt.to(f32))
            m = m_new
        out[:, i * bq:(i + 1) * bq] = (
            acc / torch.clamp_min(l, 1e-30)).to(q.dtype)
    return out


def flash_route(dtype: torch.dtype, D: int) -> str:
    """The kernel a CUDA call launches: ``"mma"`` (bf16 tensor cores) for
    bf16 with D in ``MMA_HEAD_DIMS``, ``"tf32x3"`` (3xTF32 tensor cores)
    for f32 with D in ``TF32X3_HEAD_DIMS``, else ``"fma"``.  Fixed by
    dtype and D alone, before any launch."""
    if dtype == torch.bfloat16 and D in MMA_HEAD_DIMS:
        return "mma"
    if dtype == torch.float32 and D in TF32X3_HEAD_DIMS:
        return "tf32x3"
    return "fma"


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# flash_attention_launch(dtype, route, q, k, v, out, BH, Sq, Sk, D, G,
# scale, causal, window, has_cap, cap, stream) in csrc/flash_attention.cu;
# pointers and the stream declared c_void_p (see paged_attention.py).
ARGTYPES = (_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _F,
            _P)
_NO_WINDOW = 2 ** 30


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _flash_kernel(q, k, v, *, scale, causal, window, cap, G):
    BH, Sq, D = q.shape
    dev = q.device
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention: tensors on different devices")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape \
            or k.shape[2] != D or k.shape[0] * G != BH:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         f"match (BH, S, D) with BH = {G} · kv heads")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"flash_attention kernel takes head dim 1..{MAX_D}"
                         f", got {D}")
    route = flash_route(q.dtype, D)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if route != "fma":      # 16-byte cp.async copies need aligned rows
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    win = _NO_WINDOW if window is None else int(window)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            _DTYPE_CODE[q.dtype], _ROUTE_CODE[route], q.data_ptr(),
            k.data_ptr(), v.data_ptr(),
            out.data_ptr(), BH, Sq, k.shape[1], D, G, float(scale),
            int(causal), win, int(cap is not None), float(cap or 0.0),
            stream)
    build.check(err, "flash_attention")
    return out


def flash_attention(q, k, v, *, scale: float = 1.0, causal: bool = True,
                    window=None, cap=None, bq: int = 128, bk: int = 128,
                    G: int = 1):
    """q (BH, Sq, D); k, v (BH // G, Sk, D) → (BH, Sq, D), query head
    ``i`` reading kv head ``i // G``; Sq and Sk multiples of bq and bk.

    CPU tensors take the plain version (over ``bq × bk`` tiles); CUDA
    tensors launch the kernel ``flash_route`` names, which tiles by 64
    whatever bq and bk are (counted in ``flash_attention.launches``), or
    raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale=scale, causal=causal,
                                     window=window, cap=cap, bq=bq, bk=bk,
                                     G=G)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = _flash_kernel(q, k, v, scale=scale, causal=causal, window=window,
                        cap=cap, G=G)
    flash_attention.launches += 1
    return out


register(flash_attention)
