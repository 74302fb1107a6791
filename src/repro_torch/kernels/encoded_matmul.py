"""Encoded-MAC bitplane matmul: the CUDA kernel's wrapper, its planning
and its plain PyTorch version (port of ``repro/kernels/encoded_matmul.py``).

Replaces the TPU kernel ``repro/kernels/encoded_matmul.py:_kernel``
(``encoded_matmul_pallas``), an MXU product of bf16 0/1 planes by bf16 Wt.
The CUDA source is ``repro_torch/csrc/encoded_matmul.cu``, which runs the
same product on the tensor cores, transposed (``outᵀ = Wtᵀ · planesᵀ``):

  * ``mma.sync.m16n8k16`` with Wt as the A operand (64 columns of n per
    block, read by ``ldmatrix.trans``) and the planes as B, built in
    registers from the int8 codes (never in device memory); m is padded to
    a tile of 8, 16 or 32 rows (``tile_n``), and m > 32 loops over 32-row
    passes inside the block;
  * each of a block's 4 warps streams its own run of (u, k) chunks (32 k
    of one plane, 4 KB) through a 3-stage ``cp.async`` ring, so 48 KB of
    Wt is in flight per block; the first chunk of each k column brings the
    column's int8 codes along;
  * the flattened (u, k) axis is split across the (at most 8) blocks of a
    thread-block cluster so that decode-sized calls fill the card; the
    warps meet in shared memory in warp order and the cluster's blocks
    through distributed shared memory in rank order, in the one launch, so
    results are deterministic and no partial sums reach device memory.

What bounds it on the card: the bytes of Wt, U·k·n·2, read once.  Decode
``wi`` of qwen1.5-0.5b is 8·1024·2816·2 B = 46 MB, about 14 µs at the
H100's 3.35 TB/s.  The tiling is planned here (``plan``, ``chunk_runs``)
and handed to the C entry, so the CPU tests check it.

Wt is stored on the device as bf16 once, at fold time; the reference casts
the f32 fold to bf16 at every call (``encoded_matmul.py:105``,
``ops.py:244``), so the numbers are identical.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .counts import register
from .ref import planes_ref

MAX_MONOS = 92          # csrc kMaxMonos: C(8,1)+C(8,2)+C(8,3), any 8-bit program
KC = 32                 # csrc kKC: k per chunk, one ring stage
BN = 64                 # csrc kBN: Wt columns per block
WARPS = 4               # csrc kWarps
STAGES = 3              # csrc kStages: ring stages per warp
MAX_SPLITS = 8          # csrc kMaxSplits: blocks of a (portable) cluster
TILE_NS = (8, 16, 32)   # rows per pass: the N of mma.m16n8k16, 1-4 times
BLOCKS_PER_SM = 3       # blocks the split aims for
SMEM_MAX = 232_448      # shared memory a block may use on the H100


class Plan(NamedTuple):
    """The launch of one call, as the C entry takes it."""
    tn: int                 # rows per pass (the MMA's N side)
    passes: int             # 32-row passes over m (1 for m <= 32)
    n_tiles: int            # blocks along n (grid.x)
    chunks: int             # (u, k) chunks: U · ceil(k / KC)
    splits: int             # blocks along the chunks (grid.y, one cluster)
    chunks_per_split: int
    stages: int             # ring stages per warp
    smem_bytes: int         # dynamic shared memory of a block: the rings


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


def tile_n(m: int) -> int:
    """Rows per pass: the smallest of ``TILE_NS`` that holds m, else 32."""
    return next((t for t in TILE_NS if m <= t), TILE_NS[-1])


def plan(m: int, k: int, n: int, U: int, sms: int) -> Plan:
    """Tiling of one call (m, k, n >= 1).  The (u, k) axis is split across
    the blocks of a cluster until the grid holds about ``BLOCKS_PER_SM``
    blocks per SM, keeping at least one chunk per warp."""
    tn = tile_n(m)
    n_tiles = _cdiv(n, BN)
    chunks = U * _cdiv(k, KC)
    splits = max(1, min(MAX_SPLITS, _cdiv(chunks, WARPS),
                        _cdiv(BLOCKS_PER_SM * sms, n_tiles)))
    per = _cdiv(chunks, splits)
    return Plan(tn, _cdiv(m, tn), n_tiles, chunks, _cdiv(chunks, per), per,
                STAGES, WARPS * STAGES * (KC * BN * 2 + tn * KC))


def chunk_uk(j: int, U: int) -> tuple[int, int]:
    """(u, kc) of chunk ``j``: chunks run k-major, so one chunk of codes
    serves all U planes."""
    return j % U, j // U


def chunk_runs(p: Plan) -> list[tuple[int, int]]:
    """[begin, end) chunk run of each (split, warp), in the order their sums
    meet: warps in order within a split, then splits in order."""
    per_warp = _cdiv(p.chunks_per_split, WARPS)
    runs = []
    for z in range(p.splits):
        s_end = min(p.chunks, (z + 1) * p.chunks_per_split)
        for w in range(WARPS):
            b = min(s_end, z * p.chunks_per_split + w * per_warp)
            runs.append((b, min(s_end, b + per_warp)))
    return runs


_P, _I = ctypes.c_void_p, ctypes.c_int
# encoded_matmul_launch(x, wt, bias, out, M, K, N, U, shifts, tn, splits,
# chunks_per_split, vec, stream) in csrc/encoded_matmul.cu.  Pointers
# and the stream must be declared c_void_p: undeclared, ctypes passes a
# Python int as a 32-bit C int and cuts the address.
ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I, _I, _P)


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
    (and count it in ``encoded_matmul.launches`` and, by shape, in
    ``encoded_matmul.shape_launches``) or raise."""
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
    p = plan(m, k, n, U, _sm_count(dev.index or 0))
    # 16-byte copies of Wt rows need every row 16-byte aligned
    vec = int(n % 8 == 0 and wt.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            x_codes.data_ptr(), wt.data_ptr(), bias.data_ptr(),
            out.data_ptr(), m, k, n, U, shifts.ctypes.data, p.tn, p.splits,
            p.chunks_per_split, vec, stream)
    build.check(err, "encoded_matmul")
    encoded_matmul.launches += 1
    encoded_matmul.shape_launches[(m, k, n)] += 1
    return out


# launches, and by (m, k, n) in ``shape_launches``
register(encoded_matmul, encoded_matmul_by_shape="shape_launches")
