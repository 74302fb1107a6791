"""MAC-mode configuration shared by every linear layer (port of
``MacConfig`` from ``repro/core/layers.py``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

from .mac import EncodedMac
from .macexec import get_executor


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
