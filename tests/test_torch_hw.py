"""Port parity: the paper's hardware models (``repro_torch.hw``: the
gate-level area/power model of Table 1 and the MAC arrays' latency
simulator) against the JAX package's ``repro.hw``.  Both are host
arithmetic in the same order, so every number must be equal, not close."""
import pytest

pytest.importorskip("torch")

from repro.hw import latency_encoded as j_lat_enc  # noqa: E402
from repro.hw import latency_traditional as j_lat_trad  # noqa: E402
from repro.hw import mac_array_cost as j_cost  # noqa: E402
from repro.hw import simulate_latency as j_sim  # noqa: E402
from repro.hw import table1 as j_table1  # noqa: E402
from repro.hw.systolic import throughput as j_thr  # noqa: E402

from repro_torch.hw import GATE  # noqa: E402
from repro_torch.hw import latency_encoded as t_lat_enc  # noqa: E402
from repro_torch.hw import latency_traditional as t_lat_trad  # noqa: E402
from repro_torch.hw import mac_array_cost as t_cost  # noqa: E402
from repro_torch.hw import simulate_latency as t_sim  # noqa: E402
from repro_torch.hw import table1 as t_table1  # noqa: E402
from repro_torch.hw.systolic import throughput as t_thr  # noqa: E402

SIZES = [32, 48, 64, 128, 256, 512, 1024]


@pytest.mark.parametrize("m_bits", [31, 48, 64])
def test_table1_rows_equal_reference(m_bits):
    assert t_table1(m_bits=m_bits, sizes=SIZES) == j_table1(
        m_bits=m_bits, sizes=SIZES)
    assert t_table1() == j_table1()


def test_table1_within_paper_tolerance():
    for r in t_table1():
        assert abs(r["area_red"] - r["paper_area_red"]) < 0.05, r
        assert abs(r["power_red"] - r["paper_power_red"]) < 0.05, r


@pytest.mark.parametrize("n", SIZES)
def test_mac_array_cost_equals_reference(n):
    for m in (16, 24, 31, 32, 48, 64):
        for design in ("prop", "trad"):
            assert t_cost(n, m, design) == j_cost(n, m, design), (n, m)
    assert GATE.cell_trad == 725.7


@pytest.mark.parametrize("n", [4, 32, 256])
@pytest.mark.parametrize("m", [1, 2, 7, 16])
def test_latency_and_throughput_equal_reference(n, m):
    for design in ("trad", "prop"):
        assert t_sim(n, m, design) == j_sim(n, m, design)
        assert t_thr(n, m, design) == j_thr(n, m, design)
    assert t_lat_trad(n, m) == j_lat_trad(n, m) == t_sim(n, m, "trad")
    assert t_lat_enc(n, m) == j_lat_enc(n, m) == t_sim(n, m, "prop")
