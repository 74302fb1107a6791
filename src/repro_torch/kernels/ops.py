"""Public entries for the kernels (port of ``repro/kernels/ops.py``): the
encoded matmul (monomial normalisation and its column / row
tensor-parallel dispatch; the kernel masks ragged m/k/n itself, so
nothing is padded there) and ``flash_mha``, the 4-D GQA wrapper of the
flash-attention kernel."""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.parallel.mesh import get_mesh
from . import encoded_matmul as _em
from . import flash_attention as _fa


def _norm_monos(mono_bits) -> tuple:
    """Normalize monomials to variable-arity tuples of distinct shifts.

    Accepts the padded ``(U, 3)`` array form or sequences of 1–3 bit
    positions; order within a monomial is preserved."""
    out = []
    for row in mono_bits:
        shifts = tuple(dict.fromkeys(int(b) for b in np.atleast_1d(row)))
        if not 1 <= len(shifts) <= 3:
            raise ValueError(f"monomial needs 1–3 distinct bits, got {row!r}")
        out.append(shifts)
    return tuple(out)


def _pad3(monos: tuple) -> np.ndarray:
    """(U, 3) int32 padded form (repeat the last bit)."""
    return np.asarray([(m + (m[-1],) * 3)[:3] for m in monos], np.int32
                      ).reshape(-1, 3)


def encoded_matmul(x_codes, wt, bias, mono_bits, role: str = "replicated"):
    """x_codes (m,k) int8 · wt (U,k,n) · bias (n,) → (m,n) f32.

    ``mono_bits``: (U, 3) padded array or sequence of 1–3-bit monomial
    tuples.  CPU tensors run the plain version, CUDA tensors the kernel
    (``kernels.encoded_matmul.encoded_matmul``).

    ``role``: the call's tensor-parallel dispatch on this rank (the
    reference's ``_pallas_sharded``, ``ops.py:84-109``).  'column' and
    'replicated' run the kernel on the local shapes as given (a column
    shard's ``wt``/``bias`` hold its n-slice, and its output stays
    n-sharded); 'row' (``x_codes`` and ``wt`` hold this rank's k-slice)
    runs it with a zero bias, sums the partial products over the active
    mesh's model axis, then adds the replicated ``bias`` once."""
    if isinstance(mono_bits, tuple):
        shifts = _shift_table(mono_bits)
    else:
        shifts = _pad3(_norm_monos(mono_bits))
    if role == "row":
        part = _em.encoded_matmul(x_codes, wt, torch.zeros_like(bias),
                                  shifts)
        return get_mesh().all_reduce_sum(part) + bias
    return _em.encoded_matmul(x_codes, wt, bias, shifts)


@functools.lru_cache(maxsize=64)
def _shift_table(monos: tuple) -> np.ndarray:
    """Padded (U, 3) shifts of a monomial tuple, built once per encoding
    (the serving path passes the same few tuples on every call)."""
    table = _pad3(_norm_monos(monos))
    table.flags.writeable = False
    return table


def _pad_to(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of ``x`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if not pad:
        return x
    widths = [0, 0] * (x.dim() - axis - 1) + [0, pad]
    return torch.nn.functional.pad(x, widths)


def flash_mha(q, k, v, *, scale: float, causal: bool = True, window=None,
              cap=None, bq: int = 128, bk: int = 128):
    """4-D GQA wrapper for the flash kernel: q (B, Sq, Hq, D), k/v (B, Sk,
    Hkv, D) → (B, Sq, Hq, D).

    (B, H) flatten into the kernel's leading dim; query head ``h`` reads kv
    head ``h // (Hq // Hkv)`` (the reference repeats K/V to q heads).  Sq
    and Sk are zero-padded to multiples of bq and bk: padded keys lie past
    every query position, so the causal mask hides them, and padded query
    rows are sliced off.  CPU tensors take the plain version, CUDA tensors
    the kernel (``kernels.flash_attention.flash_attention``)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (-Sk) % bk and not causal:
        raise ValueError("non-causal padding needs an explicit kv mask")
    qf = q.permute(0, 2, 1, 3).reshape(B * Hq, Sq, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, D)
    vf = v.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, D)
    qf = _pad_to(qf, bq, 1)
    kf = _pad_to(kf, bk, 1)
    vf = _pad_to(vf, bk, 1)
    out = _fa.flash_attention(qf, kf, vf, scale=scale, causal=causal,
                              window=window, cap=cap, bq=bq, bk=bk,
                              G=Hq // Hkv)
    return out[:, :Sq].reshape(B, Hq, Sq, D).permute(0, 2, 1, 3)
