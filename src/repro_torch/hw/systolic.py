"""Cycle-accurate timing simulation of the two MAC-array dataflows (§3.3;
port of ``repro/hw/systolic.py``: host arithmetic, equal results).

Traditional weight-stationary systolic array: activations skewed across
rows, partial sums propagate through one pipeline register per row, plus one
register stage at array input — an N×N×N matmul's last output lands at cycle
(3N−2); m back-to-back input matrices finish at (3N−2) + N(m−1).

Encoded array: no per-MAC psum registers — a column's N products and the
bit-wise weighted accumulation resolve combinationally within a cycle;
activations still stream column-vectors one per cycle: last output at
(2N−1); m matrices at (2N−1) + N(m−1).  (Matches the paper's formulas; the
simulation is event-based, not formula substitution.)
"""
from __future__ import annotations


def simulate_latency(n: int, m: int = 1, design: str = "prop") -> int:
    """Event simulation → cycle index of the last valid output.

    Vector ``vec`` of matrix ``k`` enters at cycle k·n + vec (one per
    cycle).  Traditional: activation row r is skewed by r cycles to meet the
    psum propagating down its column (max skew n−1), plus c horizontal input
    hops, plus the output register.  Encoded: rows are fed simultaneously
    (no skew/psum registers); only the c input hops + output register
    remain."""
    last_done = 0
    for k in range(m):
        for vec in range(n):
            t_enter = k * n + vec
            for c in (0, n - 1):                 # first/last column
                if design == "trad":
                    done = t_enter + (n - 1) + c + 1
                else:
                    done = t_enter + c + 1
                last_done = max(last_done, done)
    return last_done


def latency_traditional(n: int, m: int = 1) -> int:
    return (3 * n - 2) + n * (m - 1)


def latency_encoded(n: int, m: int = 1) -> int:
    return (2 * n - 1) + n * (m - 1)


def throughput(n: int, m: int, design: str) -> float:
    lat = latency_traditional(n, m) if design == "trad" \
        else latency_encoded(n, m)
    return m / lat
