"""Encoded-MAC bitplane matmul: the CUDA kernel's wrapper and its plain
PyTorch version (port of ``repro/kernels/encoded_matmul.py``).

Replaces the TPU kernel ``repro/kernels/encoded_matmul.py:_kernel``
(``encoded_matmul_pallas``).  The CUDA source is
``repro_torch/csrc/encoded_matmul.cu``:

  * one block of 8 warps per (256-column, BM-row, k-split) output tile,
    BM = 4 for m <= 4 (decode with a few slots) and 8 above (prefill runs
    m / 8 row tiles); each lane reads 8 columns of a Wt row with one
    16-byte load, and the 8 warps take interleaved k and meet in shared
    memory at the end;
  * the int8 x tile is staged in shared memory per 64-wide k chunk and
    turned into per-(u, k) row masks of the 0/1 planes, so planes never
    reach device memory; Wt[u] is read in bf16 and summed in f32
    registers; the bias is added once;
  * K is split across blocks so decode-sized calls fill the card; a second
    pass sums the splits in a fixed order.

What bounds it on the card: the bytes of Wt, U·k·n·2, read once.  Decode
``wi`` of qwen1.5-0.5b is 8·1024·2816·2 B = 46 MB, about 14 µs at the
H100's 3.35 TB/s.  What the simple design leaves on the table: the
plane × Wt products run on the f32 FMA pipes (BM·8 FMAs per 16 bytes of
Wt), not on the tensor cores, and prefill re-reads Wt once per 8 rows
(from L2 when the row tiles run together).  ``wgmma`` on 0/1 bf16 plane
tiles, TMA loads of Wt and a pipelined ring of stages are later work.

Wt is stored on the device as bf16 once, at fold time; the reference casts
the f32 fold to bf16 at every call (``encoded_matmul.py:105``,
``ops.py:244``), so the numbers are identical.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .ref import planes_ref

MAX_MONOS = 64          # csrc kMaxMonos
_BN = 256               # csrc kBN: output columns per block
_MIN_K = 32             # k values per split at least: 4 per warp


def encoded_matmul_plain(x_codes: torch.Tensor, wt: torch.Tensor,
                         bias: torch.Tensor, shifts) -> torch.Tensor:
    """The reference's ``backend='xla'`` path (``ops.py:242-245``): planes
    cast to bf16, Wt cast to bf16, one f32 contraction over (u, k), then
    ``+ bias``.  Both casts are exact or identical to the reference's, so
    only the f32 summation order can differ."""
    A = planes_ref(x_codes, shifts).to(torch.bfloat16).to(torch.float32)
    W = wt.to(torch.bfloat16).to(torch.float32)
    return torch.einsum("umk,ukn->mn", A, W) + bias


@functools.lru_cache(maxsize=8)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_k(m: int, k: int, n: int, bm: int, sms: int) -> tuple[int, int]:
    """(splits, k_per_split) for k >= 1: split K across blocks until the
    grid holds about two 8-warp blocks per SM, keeping at least 32 k per
    split; ``k_per_split`` is a multiple of 8, so each warp of a block
    takes the same number of k."""
    tiles = _cdiv(n, _BN) * _cdiv(m, bm)
    splits = max(1, min(_cdiv(k, _MIN_K), _cdiv(2 * sms, tiles)))
    k_per = _cdiv(_cdiv(k, splits), 8) * 8
    return _cdiv(k, k_per), k_per


_P, _I = ctypes.c_void_p, ctypes.c_int
# encoded_matmul_launch(x, wt, bias, out, workspace, M, K, N, U, shifts, bm,
# splits, k_per_split, vec, stream) in csrc/encoded_matmul.cu.  Pointers
# and the stream must be declared c_void_p: undeclared, ctypes passes a
# Python int as a 32-bit C int and cuts the address.
ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _P)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load("encoded_matmul").encoded_matmul_launch
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def encoded_matmul(x_codes: torch.Tensor, wt: torch.Tensor,
                   bias: torch.Tensor, shifts: np.ndarray) -> torch.Tensor:
    """x_codes (m,k) int8 · wt (U,k,n) bf16 · bias (n,) f32 → (m,n) f32;
    ``shifts`` (U, 3) int32 padded monomial shifts.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (and count it in ``encoded_matmul.launches``) or raise."""
    dev = x_codes.device
    if dev.type == "cpu":
        return encoded_matmul_plain(x_codes, wt, bias, shifts)
    if dev.type != "cuda":
        raise ValueError(f"encoded_matmul: unsupported device {dev}")
    if x_codes.dim() != 2 or wt.dim() != 3 or bias.dim() != 1:
        raise ValueError("encoded_matmul: expected x (m,k), wt (U,k,n), "
                         "bias (n,)")
    m, k = x_codes.shape
    U, k2, n = wt.shape
    shifts = np.ascontiguousarray(shifts, np.int32)
    if k2 != k or bias.shape[0] != n or shifts.shape != (U, 3):
        raise ValueError(f"encoded_matmul: shape mismatch x {tuple(x_codes.shape)}"
                         f", wt {tuple(wt.shape)}, bias {tuple(bias.shape)}, "
                         f"shifts {shifts.shape}")
    if (x_codes.dtype, wt.dtype, bias.dtype) != (
            torch.int8, torch.bfloat16, torch.float32):
        raise TypeError("encoded_matmul kernel takes x int8, wt bfloat16, "
                        f"bias float32; got {x_codes.dtype}, {wt.dtype}, "
                        f"{bias.dtype}")
    if not 1 <= U <= MAX_MONOS:
        raise ValueError(f"encoded_matmul kernel takes 1..{MAX_MONOS} "
                         f"monomials, got {U}")
    for t in (wt, bias):
        if t.device != dev:
            raise ValueError("encoded_matmul: tensors on different devices")
    x_codes, wt, bias = (t.contiguous() for t in (x_codes, wt, bias))
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0 or k == 0:
        return out.copy_(bias.expand(m, n))
    bm = 4 if m <= 4 else 8
    splits, k_per = split_k(m, k, n, bm, _sm_count(dev.index or 0))
    # 16-byte loads of Wt rows need every row 16-byte aligned
    vec = int(n % 8 == 0 and wt.data_ptr() % 16 == 0)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
          if splits > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            x_codes.data_ptr(), wt.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            m, k, n, U, shifts.ctypes.data, bm, splits, k_per, vec, stream)
    build.check(err, "encoded_matmul")
    encoded_matmul.launches += 1
    return out


encoded_matmul.launches = 0
