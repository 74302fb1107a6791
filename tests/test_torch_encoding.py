"""Port parity: activation quantization, the encoding core and its
bitplane decomposition (repro_torch.core / quant) against the JAX
package.  Integer and host-side results must match exactly; the fold of a
sampled circuit within f32 rounding (rtol 1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import circuits as jcirc  # noqa: E402
from repro.core import gates as jgates  # noqa: E402
from repro.core.decompose import decompose as jdecompose  # noqa: E402
from repro.kernels.ops import _norm_monos as j_norm_monos  # noqa: E402
from repro.quant.uniform import (calibrate_scale as j_calib,  # noqa: E402
                                 quantize_codes as j_quant)

from repro_torch.core import circuits as tcirc  # noqa: E402
from repro_torch.core import gates as tgates  # noqa: E402
from repro_torch.core.decompose import decompose as tdecompose  # noqa: E402
from repro_torch.kernels.ops import _norm_monos as t_norm_monos  # noqa: E402
from repro_torch.quant.uniform import (calibrate_scale as t_calib,  # noqa: E402
                                       quantize_codes as t_quant, qmax)


def _sampled_circuits(seed, M=48):
    """A reference circuit and the port's circuit from one sample."""
    gt, ii = jcirc.sample_circuits(np.random.default_rng(seed), 1, M)
    return (jcirc.Circuit(gt[0], ii[0]), tcirc.Circuit(gt[0].copy(),
                                                       ii[0].copy()))


def _programs(kind):
    if kind == "exact":
        jc, _ = jcirc.exact_product_circuit(8, 8)
        tc, _ = tcirc.exact_product_circuit(8, 8)
    else:
        jc, tc = _sampled_circuits(int(kind[-1]))
    return jdecompose(jc), tdecompose(tc)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_codes_random(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 96)).astype(np.float32) * 3.0
    sj = j_calib(jnp.asarray(x))
    st = t_calib(torch.from_numpy(x))
    assert np.float32(sj) == np.float32(st.item())
    ref = np.asarray(j_quant(jnp.asarray(x), sj))
    out = t_quant(torch.from_numpy(x), st).numpy()
    assert out.dtype == np.int8
    np.testing.assert_array_equal(out, ref)


def test_quantize_codes_half_boundaries():
    """Values exactly at k + 0.5 round half to even on both sides, and
    values past ±qmax clip."""
    scale = np.float32(0.25)
    k = np.arange(-130, 130, dtype=np.float32)
    x = np.concatenate([(k + 0.5) * scale, k * scale,
                        np.float32([1e6, -1e6])])
    ref = np.asarray(j_quant(jnp.asarray(x), jnp.float32(scale)))
    out = t_quant(torch.from_numpy(x), torch.tensor(scale)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.max() == qmax(8) and out.min() == -qmax(8)
    # round-half-even: 0.5 → 0, 1.5 → 2, 2.5 → 2
    half = t_quant(torch.tensor([0.125, 0.375, 0.625]), torch.tensor(scale))
    assert half.tolist() == [0, 2, 2]


# ---------------------------------------------------------------------------
# gates / circuits
# ---------------------------------------------------------------------------

def test_gate_tables_match():
    np.testing.assert_array_equal(tgates.GATE_ARITY, jgates.GATE_ARITY)
    np.testing.assert_array_equal(tgates.operand_bit_table(4, 4),
                                  jgates.operand_bit_table(4, 4))
    np.testing.assert_array_equal(tgates.signed_products(4, 4),
                                  jgates.signed_products(4, 4))


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_gates_match(seed):
    gt, ii = jcirc.sample_circuits(np.random.default_rng(seed), 1, 24, 4, 4)
    rows = jgates.operand_bit_table(4, 4)
    ref = np.asarray(jgates.eval_gates(jnp.asarray(gt[0]),
                                       jnp.asarray(ii[0]),
                                       jnp.asarray(rows)))
    np.testing.assert_array_equal(tgates.eval_gates(gt[0], ii[0], rows), ref)


@pytest.mark.parametrize("bits", [(4, 4), (8, 8)])
def test_exact_product_circuit_match(bits):
    jc, js = jcirc.exact_product_circuit(*bits)
    tc, ts = tcirc.exact_product_circuit(*bits)
    np.testing.assert_array_equal(tc.gate_types, jc.gate_types)
    np.testing.assert_array_equal(tc.in_idx, jc.in_idx)
    np.testing.assert_array_equal(ts, js)
    assert (tc.bits_a, tc.bits_b) == (jc.bits_a, jc.bits_b)


@pytest.mark.parametrize("mixed", [False, True])
def test_sample_circuits_match(mixed):
    ref = jcirc.sample_circuits(np.random.default_rng(5), 3, 48,
                                mixed_only=mixed)
    out = tcirc.sample_circuits(np.random.default_rng(5), 3, 48,
                                mixed_only=mixed)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# decomposition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["exact", "sampled2", "sampled1"])
def test_decompose_match(kind):
    jp, tp = _programs(kind)
    for f in ("a_mono_bits", "b_mono_bits", "coeff_map", "a_of", "b_of"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), f)
    assert tp.a_mono_tuples == jp.a_mono_tuples
    if kind == "exact":
        assert tp.n_a_planes == 8
    else:      # these sampled circuits reach 3-bit activation monomials
        assert max(len(m) for m in tp.a_mono_tuples) == 3


@pytest.mark.parametrize("kind", ["exact", "sampled2"])
@pytest.mark.parametrize("side", ["a", "b"])
def test_planes_match(kind, side):
    jp, tp = _programs(kind)
    codes = np.random.default_rng(3).integers(-127, 128, (17, 33)
                                              ).astype(np.int8)
    ref = np.asarray(jp.planes(jnp.asarray(codes), side))
    out = tp.planes(torch.from_numpy(codes), side).numpy()
    assert out.dtype == np.int8
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("kind", ["exact", "sampled2"])
def test_norm_monos_match(kind):
    jp, _ = _programs(kind)
    assert t_norm_monos(jp.a_mono_bits) == j_norm_monos(jp.a_mono_bits)
    assert t_norm_monos(jp.a_mono_tuples) == j_norm_monos(jp.a_mono_tuples)
    with pytest.raises(ValueError):
        t_norm_monos([()])


@pytest.mark.parametrize("kind", ["exact", "sampled2", "sampled1"])
def test_fold_weights_match(kind):
    jp, tp = _programs(kind)
    rng = np.random.default_rng(4)
    w = rng.integers(-127, 128, (40, 24)).astype(np.int8)
    if kind == "exact":
        _, s = jcirc.exact_product_circuit(8, 8)
    else:
        s = rng.normal(size=(48,)).astype(np.float32)
    jW, jb = jp.fold_weights(jnp.asarray(w), jnp.asarray(s))
    tW, tb = tp.fold_weights(torch.from_numpy(w), torch.from_numpy(s))
    if kind == "exact":
        np.testing.assert_array_equal(tW.numpy(), np.asarray(jW))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    else:
        np.testing.assert_allclose(tW.numpy(), np.asarray(jW), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(jW)).max())
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(jb)).max())
