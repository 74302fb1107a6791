"""Port parity: the encoded bitplane matmul's plain PyTorch version (the
path CPU tensors take) against the reference's ``ops.encoded_matmul``
(``backend='xla'`` and the Pallas kernel in interpret mode).  Both sides
round planes and Wt to bf16 at the same places, so only the f32
summation order differs: rtol 1e-5, atol 1e-4."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import circuits as jcirc  # noqa: E402
from repro.core.decompose import decompose as jdecompose  # noqa: E402
from repro.kernels.ops import encoded_matmul as j_encoded_matmul  # noqa: E402
from repro.kernels.ref import encoded_matmul_ref as j_ref  # noqa: E402

from repro_torch.kernels import encoded_matmul as tem  # noqa: E402
from repro_torch.kernels.ops import encoded_matmul as t_encoded_matmul  # noqa: E402
from repro_torch.kernels.ref import encoded_matmul_ref as t_ref  # noqa: E402


def _program(kind):
    if kind == "exact":
        c, _ = jcirc.exact_product_circuit(8, 8)
    else:              # M = 48 with 3-bit activation monomials
        gt, ii = jcirc.sample_circuits(np.random.default_rng(2), 1, 48)
        c = jcirc.Circuit(gt[0], ii[0])
    return jdecompose(c)


def _case(kind, m, k, n, seed=0):
    prog = _program(kind)
    U = prog.n_a_planes
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wt = (rng.normal(size=(U, k, n)) * 4).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32)
    return prog, x, wt, bias


def _port(prog, x, wt, bias, monos=None):
    out = t_encoded_matmul(torch.from_numpy(x),
                           torch.from_numpy(wt).to(torch.bfloat16),
                           torch.from_numpy(bias),
                           prog.a_mono_tuples if monos is None else monos)
    assert out.dtype == torch.float32
    return out.numpy()


SHAPES = [(1, 256, 128), (100, 130, 70), (4, 64, 96), (32, 96, 40)]


@pytest.mark.parametrize("kind", ["exact", "sampled"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference_xla(kind, shape):
    prog, x, wt, bias = _case(kind, *shape)
    ref = np.asarray(j_encoded_matmul(jnp.asarray(x), jnp.asarray(wt),
                                      jnp.asarray(bias), prog.a_mono_tuples,
                                      backend="xla"))
    np.testing.assert_allclose(_port(prog, x, wt, bias), ref,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["exact", "sampled"])
@pytest.mark.parametrize("shape", [(1, 256, 128), (100, 130, 70)])
def test_plain_matches_reference_pallas_interpret(kind, shape):
    prog, x, wt, bias = _case(kind, *shape, seed=1)
    ref = np.asarray(j_encoded_matmul(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
        prog.a_mono_tuples, backend="pallas_interpret", bm=32, bn=32, bk=32))
    np.testing.assert_allclose(_port(prog, x, wt, bias), ref,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["exact", "sampled"])
def test_padded_and_tuple_monomials_agree(kind):
    """AND is idempotent: the padded (U, 3) form and the variable-arity
    tuples give the same product."""
    prog, x, wt, bias = _case(kind, 5, 48, 24)
    np.testing.assert_array_equal(_port(prog, x, wt, bias, prog.a_mono_bits),
                                  _port(prog, x, wt, bias))


@pytest.mark.parametrize("kind", ["exact", "sampled"])
def test_f32_oracle_matches_reference(kind):
    prog, x, wt, bias = _case(kind, 7, 50, 30)
    ref = np.asarray(j_ref(jnp.asarray(x), jnp.asarray(wt),
                           jnp.asarray(bias), prog.a_mono_bits))
    out = t_ref(torch.from_numpy(x), torch.from_numpy(wt),
                torch.from_numpy(bias), prog.a_mono_bits).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def test_cpu_tensors_never_count_as_launches():
    prog, x, wt, bias = _case("exact", 3, 32, 16)
    before = tem.encoded_matmul.launches
    _port(prog, x, wt, bias)
    assert tem.encoded_matmul.launches == before


@pytest.mark.parametrize("m,k,n", [(1, 1024, 2816), (33, 100, 70),
                                   (4, 2816, 1024)])
def test_split_k_covers_k(m, k, n):
    """Every k-split covers a multiple of 8 k (the kernel's 8 warps take
    the same count), and together they cover k exactly once."""
    bm = 4 if m <= 4 else 8
    splits, k_per = tem.split_k(m, k, n, bm, sms=132)
    assert k_per % 8 == 0 and splits >= 1
    assert (splits - 1) * k_per < k <= splits * k_per
