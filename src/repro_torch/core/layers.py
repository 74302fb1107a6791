"""MAC-mode configuration shared by every linear layer, and the paper's
dense and conv layers over it (port of ``repro/core/layers.py``).

The conv layer is im2col over the (encoded) dense GEMM in NHWC, with
JAX's SAME padding: at stride 2 on an even size the padding is (0, 1),
not (1, 1), so the first window starts at pixel (0, 0)."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.quant.uniform import calibrate_scale
from .mac import EncodedMac
from .macexec import get_executor, record_activation


@dataclasses.dataclass(frozen=True)
class MacConfig:
    """``mode`` names a registered MacExecutor: 'fp', 'int8' (fake-quant
    QAT), 'encoded' (encoded-MAC QAT with trainable position weights, one
    ``_s`` per linear when ``per_layer_s``) or 'encoded_infer' (serving).

    ``macs`` holds the per-projection-family encodings of the serving
    path, keyed by the linear's param name ('wq', 'wk', …).  The kernel
    route is not configured here: it follows the tensors' device."""
    mode: str = "fp"
    bits: int = 8
    per_layer_s: bool = True         # trainable position weights per layer
    mac: Optional[EncodedMac] = None
    macs: Optional[dict] = None

    def with_mode(self, mode: str) -> "MacConfig":
        return dataclasses.replace(self, mode=mode)

    @property
    def executor(self):
        return get_executor(self.mode)

    def mac_for(self, name: str) -> EncodedMac:
        """Projection-family encoding for linear ``name`` (falls back to
        the shared ``mac``)."""
        m = (self.macs or {}).get(name, self.mac)
        if m is None:
            raise KeyError(f"no encoding for projection family {name!r}")
        return m


# The dense layer keeps its historical param names ('s', 'a_scale') while
# the executors use the suffix schema ('w_s', 'w_as'); these pairs
# translate.
_DENSE_ALIASES = (("s", "w_s"), ("a_scale", "w_as"))


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               cfg: MacConfig, w_scale: Optional[float] = None) -> dict:
    """A dense layer's params on the host, drawn from ``generator`` (a
    CPU generator)."""
    p = cfg.executor.init(generator, d_in, d_out, "w", cfg, scale=w_scale)
    for legacy, suffixed in _DENSE_ALIASES:
        if suffixed in p:
            p[legacy] = p.pop(suffixed)
    return p


def dense_apply(p: dict, x: torch.Tensor, cfg: MacConfig) -> torch.Tensor:
    """x (..., d_in) → (..., d_out) f32 under the configured MAC executor;
    the recorder hook sees the call as the LM linears'."""
    q = dict(p)
    for legacy, suffixed in _DENSE_ALIASES:
        if legacy in q:
            q[suffixed] = q.pop(legacy)
    record_activation("w", q["w"], x)
    return cfg.executor.apply(q, "w", x, cfg, torch.float32)


def calibrate_dense(p: dict, x: torch.Tensor, cfg: MacConfig) -> dict:
    """Set the activation scale buffer from a calibration batch."""
    if "a_scale" not in p:
        return p
    return dict(p, a_scale=calibrate_scale(x.reshape(-1, x.shape[-1]),
                                           cfg.bits))


# --- conv as im2col over the encoded GEMM ----------------------------------

def conv_init(generator: torch.Generator, k_h: int, k_w: int, c_in: int,
              c_out: int, cfg: MacConfig) -> dict:
    return dense_init(generator, k_h * k_w * c_in, c_out, cfg,
                      w_scale=1.0 / math.sqrt(k_h * k_w * c_in))


def _same_pads(size: int, k: int, stride: int) -> tuple:
    """JAX's SAME padding of one spatial dim: (out, low, high), the odd
    pixel on the high side."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def conv_patches(x: torch.Tensor, k_h: int, k_w: int,
                 stride: int = 1) -> torch.Tensor:
    """NHWC patches (n, h', w', k_h·k_w·c) under SAME padding, features in
    (kh, kw, c) order (the HWIO-flattened weights' rows), as the
    reference's ``conv_general_dilated_patches`` and its reorder give
    them."""
    _, h, w, _ = x.shape
    oh, lh, hh = _same_pads(h, k_h, stride)
    ow, lw, hw = _same_pads(w, k_w, stride)
    x = F.pad(x, (0, 0, lw, hw, lh, hh))
    cols = [x[:, i:i + stride * (oh - 1) + 1:stride,
              j:j + stride * (ow - 1) + 1:stride, :]
            for i in range(k_h) for j in range(k_w)]
    return torch.cat(cols, dim=-1)


def conv_apply(p: dict, x: torch.Tensor, cfg: MacConfig, k_h: int, k_w: int,
               stride: int = 1) -> torch.Tensor:
    """NHWC conv (SAME padding) via patch extraction + (encoded) dense
    GEMM."""
    return dense_apply(p, conv_patches(x, k_h, k_w, stride), cfg)
