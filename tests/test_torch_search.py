"""Port parity: the encoding search's pieces (``repro_torch.core.gates``,
``encoding``, ``search``, ``mac``, ``quant.uniform.code_histogram``,
``ckpt``) against the JAX package, on the CPU.

Tolerances: the least-squares fit sums its f32 normal equations in
another order than XLA, so RMSEs agree within rtol 1e-5 (measured in
``test_fit_position_weights_matches_reference``: at most 1.1e-6) and the
fitted tables ``B·s`` within 1e-4·max|v| (``s`` itself is not unique:
duplicate gate outputs make B rank deficient; measured at most
8.6e-6·max|v|).  Everything
integer or host-side — circuits, histograms, the search's choices and
sample counts, files — must match exactly."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.ckpt import load_array_tree as j_load_tree  # noqa: E402
from repro.ckpt import save_array_tree as j_save_tree  # noqa: E402
from repro.core import circuits as jcirc  # noqa: E402
from repro.core import gates as jgates  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.encoding import EncodingSpec as JSpec  # noqa: E402
from repro.core.encoding import fit_position_weights as j_fit  # noqa: E402
from repro.core.encoding import rmse_of as j_rmse_of  # noqa: E402
from repro.core.mac import EncodedMac as JMac  # noqa: E402
from repro.core.mac import lut_matmul as j_lut_matmul  # noqa: E402
from repro.quant.uniform import code_histogram as j_hist  # noqa: E402

from repro_torch.ckpt import load_array_tree as t_load_tree  # noqa: E402
from repro_torch.ckpt import save_array_tree as t_save_tree  # noqa: E402
from repro_torch.core import circuits as tcirc  # noqa: E402
from repro_torch.core import gates as tgates  # noqa: E402
from repro_torch.core import mac as tmac  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.encoding import EncodingSpec as TSpec  # noqa: E402
from repro_torch.core.encoding import fit_circuit as t_fit_circuit  # noqa: E402
from repro_torch.core.encoding import fit_position_weights as t_fit  # noqa: E402
from repro_torch.core.encoding import rmse_of as t_rmse_of  # noqa: E402
from repro_torch.core.encoding import truth_table_bits as t_truth_table  # noqa: E402
from repro_torch.core.mac import EncodedMac as TMac  # noqa: E402
from repro_torch.core.mac import lut_matmul as t_lut_matmul  # noqa: E402
from repro_torch.quant.uniform import code_histogram as t_hist  # noqa: E402

RMSE_RTOL = 1e-5
LUT_ATOL = 1e-4        # times max|v|


def _row_weights(seed, bits=8):
    """Row weights shaped like the serving calibration's: a blend of a
    peaked joint code distribution with uniform, mean about 1."""
    rng = np.random.default_rng(seed)
    pa = rng.dirichlet(np.full(1 << bits, 0.3))
    pb = rng.dirichlet(np.full(1 << bits, 0.3))
    T = 1 << (2 * bits)
    return (0.5 * np.outer(pa, pb).reshape(-1) * T + 0.5).astype(np.float32)


def _same_circuit(t, j):
    np.testing.assert_array_equal(t.gate_types, j.gate_types)
    np.testing.assert_array_equal(t.in_idx, j.in_idx)
    assert (t.bits_a, t.bits_b) == (j.bits_a, j.bits_b)


def _to_port_spec(spec):
    c = spec.circuit
    return TSpec(tcirc.Circuit(c.gate_types.copy(), c.in_idx.copy(),
                               c.bits_a, c.bits_b),
                 np.asarray(spec.s), spec.rmse, spec.values)


# ---------------------------------------------------------------------------
# gates, circuits, tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,M", [(4, 24), (8, 48)])
def test_eval_gates_batch_matches_reference(bits, M):
    gt, ii = jcirc.sample_circuits(np.random.default_rng(bits), 5, M, bits,
                                   bits)
    rows = jgates.operand_bit_table(bits, bits)[:3000]
    out = tgates.eval_gates_batch(gt, ii, torch.from_numpy(rows))
    assert out.shape == (5, len(rows), M) and out.dtype == torch.int8
    for c in range(5):
        ref = np.asarray(jgates.eval_gates(jnp.asarray(gt[c]),
                                           jnp.asarray(ii[c]),
                                           jnp.asarray(rows)))
        np.testing.assert_array_equal(out[c].numpy(), ref)


def test_gate_tables_and_helpers_match_reference():
    assert tgates.GATE_NAMES == jgates.GATE_NAMES
    np.testing.assert_array_equal(tgates.GATE_AREA_GE, jgates.GATE_AREA_GE)
    v = np.arange(-128, 128, dtype=np.int32)
    np.testing.assert_array_equal(
        tgates.int_to_bits(torch.from_numpy(v), 8).numpy(),
        np.asarray(jgates.int_to_bits(jnp.asarray(v), 8)))
    la, lb = np.linspace(-1, 1, 7), np.linspace(-2, 3, 5)
    np.testing.assert_array_equal(tgates.level_products(la, lb),
                                  jgates.level_products(la, lb))


def test_circuit_metadata_matches_reference():
    gt, ii = jcirc.sample_circuits(np.random.default_rng(3), 2, 48)
    jc = jcirc.circuit_from_batch(gt, ii, 1)
    tc = tcirc.circuit_from_batch(gt, ii, 1)
    _same_circuit(tc, jc)
    assert tc.n_inputs == jc.n_inputs == 16
    assert tc.gate_equivalents() == jc.gate_equivalents()
    assert tc.to_json() == jc.to_json()
    tc.validate()
    _same_circuit(tcirc.Circuit.from_json(jc.to_json()), jc)
    (jf, js), (tf, ts) = jcirc.paper_fig2_circuit(), tcirc.paper_fig2_circuit()
    _same_circuit(tf, jf)
    np.testing.assert_array_equal(ts, js)
    bad = tcirc.Circuit(tc.gate_types, tc.in_idx.copy())
    bad.in_idx[0, 0] = 16
    with pytest.raises(ValueError, match="input index"):
        bad.validate()


# ---------------------------------------------------------------------------
# the least-squares fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("M", [16, 48])
def test_fit_position_weights_matches_reference(M, weighted):
    gt, ii = jcirc.sample_circuits(np.random.default_rng(M), 16, M)
    vals = jgates.signed_products(8, 8)
    w = _row_weights(M) if weighted else None
    s_j, r_j = j_fit(gt, ii, vals, row_weights=w)
    s_t, r_t = t_fit(gt, ii, vals, row_weights=w, device="cpu")
    assert s_t.shape == (16, M) and s_t.dtype == np.float32
    np.testing.assert_allclose(r_t, r_j, rtol=RMSE_RTOL)
    vmax = np.abs(vals).max()
    for i in range(len(gt)):
        B = t_truth_table(tcirc.circuit_from_batch(gt, ii, i)).astype(
            np.float32)
        np.testing.assert_allclose(B @ s_t[i], B @ s_j[i], rtol=0,
                                   atol=LUT_ATOL * vmax)
    # EncodingSpec.lut is that table, in f32, shaped (2^8, 2^8)
    jspec = JSpec(jcirc.circuit_from_batch(gt, ii, 0), s_j[0], 0.0)
    tspec = TSpec(tcirc.circuit_from_batch(gt, ii, 0), s_t[0], 0.0)
    np.testing.assert_allclose(tspec.lut().numpy(), np.asarray(jspec.lut()),
                               rtol=0, atol=LUT_ATOL * vmax)
    np.testing.assert_allclose(tspec.lut(s_j[0]).numpy(),
                               np.asarray(jspec.lut()), rtol=1e-6,
                               atol=1e-6 * vmax)


def test_fit_does_not_depend_on_the_batch():
    """A circuit's fit is the same bits whatever batch it is in and where:
    an anneal step that leaves a circuit unchanged reproduces its RMSE, so
    the search's strict ``<`` rejects it."""
    gt, ii = jcirc.sample_circuits(np.random.default_rng(7), 21, 48)
    vals = jgates.signed_products(8, 8)
    w = _row_weights(7)
    s, r = t_fit(gt, ii, vals, row_weights=w, device="cpu")
    perm = np.random.default_rng(8).permutation(21)
    s2, r2 = t_fit(gt[perm], ii[perm], vals, row_weights=w, device="cpu")
    np.testing.assert_array_equal(r2, r[perm])
    np.testing.assert_array_equal(s2, s[perm])
    s3, r3 = t_fit(gt[5:6], ii[5:6], vals, row_weights=w, device="cpu")
    np.testing.assert_array_equal(r3, r[5:6])


def test_fit_circuit_and_rmse_of_match_reference():
    from repro.core.encoding import fit_circuit as j_fit_circuit
    gt, ii = jcirc.sample_circuits(np.random.default_rng(11), 1, 48)
    jspec = j_fit_circuit(jcirc.Circuit(gt[0], ii[0]))
    tspec = t_fit_circuit(tcirc.Circuit(gt[0], ii[0]), device="cpu")
    assert tspec.rmse == pytest.approx(jspec.rmse, rel=RMSE_RTOL)
    w = _row_weights(11)
    for s in (jspec.s, tspec.s):
        for rw in (None, w):
            assert t_rmse_of(tspec.circuit, s, row_weights=rw) == \
                pytest.approx(j_rmse_of(jspec.circuit, s, row_weights=rw),
                              rel=1e-6)
    # the direct evaluation confirms the normal-equation RMSE
    assert t_rmse_of(tspec.circuit, tspec.s) == pytest.approx(tspec.rmse,
                                                               rel=1e-4)
    # an exact encoding fits to RMSE 0 in both
    tc, ts = tcirc.exact_product_circuit(4, 4)
    assert t_rmse_of(tc, ts) == 0.0
    assert t_fit_circuit(tc, device="cpu").rmse < 1e-2


# ---------------------------------------------------------------------------
# code histograms (the calibration's row weights)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
def test_code_histogram_matches_reference_bit_for_bit(bits):
    rng = np.random.default_rng(bits)
    m = (1 << (bits - 1)) - 1
    scale = np.float32(0.0371)
    k = np.arange(-m - 3, m + 3, dtype=np.float64)
    x = np.concatenate([
        rng.normal(size=5000).astype(np.float32) * 2.0,
        # exactly ±0.5 past an integer code in f64, and clipped values
        ((k + 0.5) * np.float64(scale)).astype(np.float32),
        ((k - 0.5) * np.float64(scale)).astype(np.float32),
        np.float32([1e6, -1e6, 0.0])])
    for sc in (scale, float(scale) / 3.0, torch.tensor(scale)):
        ref = j_hist(x, np.asarray(sc), bits)
        for v in (x, torch.from_numpy(x)):
            out = t_hist(v, sc, bits)
            assert out.dtype == np.float64 and out.shape == (1 << bits,)
            np.testing.assert_array_equal(out, ref)


def test_code_histogram_rounds_half_to_even():
    h = t_hist(np.float32([0.5, 1.5, 2.5, -0.5, -1.5]), 1.0, 8)
    counts = h * 5
    assert counts[0] == 2 and counts[2] == 2 and counts[254] == 1
    np.testing.assert_array_equal(h, j_hist(np.float32(
        [0.5, 1.5, 2.5, -0.5, -1.5]), 1.0, 8))


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------

# An anneal step's candidates can sit within f32 rounding of each other and
# of the current circuit (a gate that adds next to nothing swapped for
# another): the RMSEs come from f32 normal equations summed in another
# order than XLA's, about 1e-7 relative apart, less than one f32 ulp of
# an RMSE near 3000 (2.4e-4).  There the two packages may choose
# differently.  Such a case is recorded in ROADMAP Queue C with the step
# where the choices part, and its test asserts that step and that the
# candidates involved are within TIE_RTOL of each other in both packages
# (``_first_choice_apart``; the seeds below have none).
TIE_RTOL = 1e-6
SEARCH_M = 32


def _first_choice_apart(spec, seed, iters, batch, w, temp0):
    """None if the port's fits make ``anneal`` choose as the reference's
    at every step, else (step, spread under the reference's fits, spread
    under the port's) (``core.search.anneal_choices_apart``)."""
    vals = spec.values
    return tsearch.anneal_choices_apart(
        spec, seed, iters,
        lambda gt, ii: j_fit(gt, ii, vals, row_weights=w)[1],
        lambda gt, ii: t_fit(gt, ii, vals, row_weights=w, device="cpu")[1],
        batch=batch, temp0=temp0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_search_matches_reference(seed, weighted):
    """Across batches (16 samples each), up to the early stop."""
    w = _row_weights(seed) if weighted else None
    kw = dict(batch=16, patience=16, rel_tol=0.02, row_weights=w)
    rj = jsearch.random_search(seed, SEARCH_M, 64, **kw)
    rt = tsearch.random_search(seed, SEARCH_M, 64, device="cpu", **kw)
    _same_circuit(rt.spec.circuit, rj.spec.circuit)
    assert rt.n_samples == rj.n_samples
    np.testing.assert_allclose(rt.rmse_trace, rj.rmse_trace, rtol=RMSE_RTOL)
    assert rt.spec.rmse == pytest.approx(rj.spec.rmse, rel=RMSE_RTOL)


@pytest.mark.parametrize("seed,weighted,temp0", [
    (0, False, 0.0), (0, True, 50.0), (1, True, 0.0), (1, False, 50.0),
    (2, False, 0.0), (2, True, 50.0)])
def test_anneal_matches_reference(seed, weighted, temp0):
    """From the reference's random-search result, 32 greedy or annealed
    steps in batches of 16."""
    w = _row_weights(seed + 10) if weighted else None
    start = jsearch.random_search(seed, SEARCH_M, 16, batch=16, patience=16,
                                  row_weights=w)
    aj = jsearch.anneal(start.spec, seed + 7919, 32, temp0=temp0, batch=16,
                        row_weights=w)
    at = tsearch.anneal(_to_port_spec(start.spec), seed + 7919, 32,
                        temp0=temp0, batch=16, row_weights=w, device="cpu")
    assert at.n_samples == aj.n_samples == 32
    # every step's choice is the reference's, not only the outcome
    assert _first_choice_apart(start.spec, seed + 7919, 32, 16, w,
                               temp0) is None
    _same_circuit(at.spec.circuit, aj.spec.circuit)
    np.testing.assert_allclose(at.rmse_trace, aj.rmse_trace, rtol=RMSE_RTOL)


def test_binary_search_width_matches_reference():
    """Widths 28..36 at 16 samples each, with refinement."""
    kw = dict(lo=28, hi=36, n_samples=16, refine=16)
    sj, hj = jsearch.binary_search_width(3, 4500.0, **kw)
    st, ht = tsearch.binary_search_width(3, 4500.0, device="cpu", **kw)
    assert [h["width"] for h in ht] == [h["width"] for h in hj]
    assert [h["meets_target"] for h in ht] == [h["meets_target"] for h in hj]
    assert any(h["meets_target"] for h in hj) and \
        not all(h["meets_target"] for h in hj)
    np.testing.assert_allclose([h["rmse"] for h in ht],
                               [h["rmse"] for h in hj], rtol=RMSE_RTOL)
    _same_circuit(st.circuit, sj.circuit)


# ---------------------------------------------------------------------------
# artifacts: each package reads the other's files
# ---------------------------------------------------------------------------

def test_encoded_mac_json_round_trips_between_packages(tmp_path):
    spec = jsearch.random_search(4, 48, 8, patience=8).spec
    JMac.save(spec, "from_ref", artifact_dir=str(tmp_path))
    TMac.save(_to_port_spec(spec), "from_port", artifact_dir=str(tmp_path))
    with open(tmp_path / "from_ref.json") as f, \
            open(tmp_path / "from_port.json") as g:
        assert json.load(f) == json.load(g)
    for name in ("from_ref", "from_port"):
        t = TMac.load(name, artifact_dir=str(tmp_path))
        j = JMac.load(name, artifact_dir=str(tmp_path))
        _same_circuit(t.spec.circuit, j.spec.circuit)
        np.testing.assert_array_equal(t.spec.s, j.spec.s)
        assert t.spec.rmse == j.spec.rmse
        np.testing.assert_array_equal(t.s_init, spec.s)
        np.testing.assert_array_equal(t.program.a_mono_bits,
                                      j.program.a_mono_bits)


def test_default_encoding_is_searched_once_then_loaded(tmp_path, monkeypatch):
    monkeypatch.setattr(tmac, "_ARTIFACT_DIR", str(tmp_path))
    first = TMac.default(n_samples=8, refine=4, device="cpu")
    assert os.path.exists(tmp_path / "enc48_8x8.json")
    second = TMac.default(n_samples=8, refine=4, device="cpu")
    _same_circuit(second.spec.circuit, first.spec.circuit)
    np.testing.assert_array_equal(second.spec.s, first.spec.s)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_array_trees_round_trip_between_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    layers = [rng.normal(size=(3, 5, 4)).astype(np.float32)
              for _ in range(2)]
    tree = {"stack": {"attn": {"wq_fw": np.stack(layers),
                               "wq_as": np.float32([0.5, 0.25])}},
            "lm_head": {"w_ws": np.float32(2.0),
                        "bits": np.arange(6, dtype=np.uint16)}}
    path = str(tmp_path / "t.npz")
    if writer == "port":
        # a list leaf is written as the stack of its parts
        streamed = {"stack": {"attn": {"wq_fw": layers,
                                       "wq_as": tree["stack"]["attn"]
                                       ["wq_as"]}},
                    "lm_head": tree["lm_head"]}
        t_save_tree(path, streamed)
    else:
        j_save_tree(path, tree)
    assert os.listdir(tmp_path) == ["t.npz"]
    for load in (t_load_tree, j_load_tree):
        got = load(path)
        for sub, leaves in (("attn", tree["stack"]["attn"]),):
            for k, v in leaves.items():
                np.testing.assert_array_equal(got["stack"][sub][k], v)
                assert got["stack"][sub][k].dtype == v.dtype
        for k, v in tree["lm_head"].items():
            np.testing.assert_array_equal(got["lm_head"][k], v)
            assert got["lm_head"][k].dtype == v.dtype


def test_lut_matmul_matches_reference():
    spec = jsearch.random_search(5, 48, 8, patience=8).spec
    rng = np.random.default_rng(5)
    x = rng.integers(-127, 128, (6, 20)).astype(np.int8)
    w = rng.integers(-127, 128, (20, 9)).astype(np.int8)
    ref = np.asarray(j_lut_matmul(jnp.asarray(x), jnp.asarray(w),
                                  spec.lut()))
    out = t_lut_matmul(torch.from_numpy(x), torch.from_numpy(w),
                       _to_port_spec(spec).lut())
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-4 * np.abs(ref).max())
