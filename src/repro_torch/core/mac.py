"""The encoded-MAC handle models carry (port of ``EncodedMac`` from
``repro/core/mac.py``)."""
from __future__ import annotations

import dataclasses

from .encoding import EncodingSpec
from .decompose import BitplaneProgram, decompose


@dataclasses.dataclass
class EncodedMac:
    """Bundle of (spec, program)."""
    spec: EncodingSpec
    program: BitplaneProgram

    @staticmethod
    def from_spec(spec: EncodingSpec) -> "EncodedMac":
        return EncodedMac(spec, decompose(spec.circuit))
