"""Analytical gate-level area/power model for MAC arrays (paper Table 1;
port of ``repro/hw/costmodel.py``: host arithmetic, equal results).

Instead of Design Compiler + NanGate-15nm synthesis, the model counts gate
equivalents (GE, NAND2-equivalent) with constants CALIBRATED by least squares
against the paper's five synthesized rows under the physical structure:

  trad array : N² · cell_trad                      (multiplier 417 GE +
               24b accumulator + product/psum/act FFs ≈ 741 GE)
  prop array : N² · cell_enc  +  N · (48·fa·(N−1) + dec)
               cell_enc = M single-level gates + shared operand regs;
               48·fa·(N−1) = M popcount compressor trees per column;
               dec = decoder (count×position-weight multipliers + adder tree)

Power uses the same structure with its own effective-GE constants (switching
activity folded in).  Max model-vs-paper deviation is ~11 % (32×32 power),
<6 % elsewhere — reported row by row by ``apps.paper``'s Table 1 experiment.
Scaling BEYOND the paper's table (N=512/1024, M≠48) is prediction, not fit.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GateLib:
    """Calibrated on the paper's 32×32 and 256×256 rows (both designs fit an
    N²·cell + N·column structure; remaining rows are predictions, ≤6% off).
    Column terms: traditional = I/O + psum output stages; encoded = popcount
    compressors + decoder (count × position-weight multipliers + tree)."""
    area_per_ge_mm2: float = 0.2778e-6   # mm² per GE (NanGate15 class)
    power_per_ge_w: float = 1.976e-7     # W per GE at 1 GHz
    # area GEs
    cell_trad: float = 725.7
    col_trad: float = 3664.0
    cell_enc_per_bit: float = 85.9 / 48.0    # scales with M
    col_enc_per_bit: float = 16600.0 / 48.0  # popcount+decoder, scales w/ M
    # power effective-GEs (switching activity folded in)
    p_cell_trad: float = 716.9
    p_col_trad: float = 5682.0
    p_cell_enc_per_bit: float = 136.7 / 48.0
    p_col_enc_per_bit: float = 21417.0 / 48.0


GATE = GateLib()


def mac_array_cost(n: int, m_bits: int = 48, design: str = "prop",
                   lib: GateLib = GATE) -> dict:
    """Area (mm²) and power (W) of an n×n MAC array at 1 GHz."""
    if design == "trad":
        a_ge = n * n * lib.cell_trad + n * lib.col_trad
        p_ge = n * n * lib.p_cell_trad + n * lib.p_col_trad
    else:
        a_ge = n * n * m_bits * lib.cell_enc_per_bit \
            + n * m_bits * lib.col_enc_per_bit
        p_ge = n * n * m_bits * lib.p_cell_enc_per_bit \
            + n * m_bits * lib.p_col_enc_per_bit
    return {"area_mm2": a_ge * lib.area_per_ge_mm2,
            "power_w": p_ge * lib.power_per_ge_w,
            "gate_equivalents": a_ge}


PAPER_TABLE1 = {
    # N: (trad_power, prop_power, trad_area, prop_area)
    32:  (0.181, 0.163, 0.239, 0.172),
    48:  (0.380, 0.259, 0.513, 0.268),
    64:  (0.652, 0.404, 0.891, 0.416),
    128: (2.464, 1.050, 3.433, 1.043),
    256: (9.572, 2.854, 13.473, 2.744),
}


def table1(m_bits: int = 48, lib: GateLib = GATE,
           sizes=None) -> list[dict]:
    rows = []
    for n in (sizes or PAPER_TABLE1):
        t = mac_array_cost(n, m_bits, "trad", lib)
        p = mac_array_cost(n, m_bits, "prop", lib)
        row = {
            "N": n,
            "power_trad_w": t["power_w"], "power_prop_w": p["power_w"],
            "power_red": 1 - p["power_w"] / t["power_w"],
            "area_trad_mm2": t["area_mm2"], "area_prop_mm2": p["area_mm2"],
            "area_red": 1 - p["area_mm2"] / t["area_mm2"],
        }
        if n in PAPER_TABLE1:
            tp, pp, ta, pa = PAPER_TABLE1[n]
            row.update(paper_power_red=1 - pp / tp,
                       paper_area_red=1 - pa / ta,
                       paper_power_trad=tp, paper_power_prop=pp,
                       paper_area_trad=ta, paper_area_prop=pa)
        rows.append(row)
    return rows
