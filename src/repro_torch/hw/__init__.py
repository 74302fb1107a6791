"""The paper's hardware models (port of ``repro/hw``)."""
from .costmodel import mac_array_cost, table1, GATE
from .systolic import simulate_latency, latency_traditional, latency_encoded
