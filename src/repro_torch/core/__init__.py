"""Encoding-based MAC core (port of ``repro/core``): circuits, their
bitplane decomposition, and the MAC executors every linear dispatches to."""
from .circuits import Circuit, sample_circuits, exact_product_circuit
from .encoding import EncodingSpec
from .decompose import BitplaneProgram, decompose
from .mac import EncodedMac
from .layers import MacConfig
