"""Port parity: the encoded bitplane matmul's plain PyTorch version (the
path CPU tensors take) against the reference's ``ops.encoded_matmul``
(``backend='xla'`` and the Pallas kernel in interpret mode).  Both sides
round planes and Wt to bf16 at the same places, so only the f32
summation order differs: rtol 1e-5, atol 1e-4."""
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.core import circuits as jcirc  # noqa: E402
from repro.core.decompose import decompose as jdecompose  # noqa: E402
from repro.kernels.ops import encoded_matmul as j_encoded_matmul  # noqa: E402
from repro.kernels.ref import encoded_matmul_ref as j_ref  # noqa: E402

from repro_torch.kernels import encoded_matmul as tem  # noqa: E402
from repro_torch.kernels.ops import encoded_matmul as t_encoded_matmul  # noqa: E402
from repro_torch.kernels.ref import encoded_matmul_ref as t_ref  # noqa: E402


def _all_monomials():
    """Every 1–3-bit monomial of the 8 activation bits, C(8,1) + C(8,2) +
    C(8,3) = 92: the most planes an 8-bit program can have."""
    monos = tuple(m for r in (1, 2, 3)
                  for m in itertools.combinations(range(8), r))
    bits = np.asarray([list(m) + [m[-1]] * (3 - len(m)) for m in monos],
                      np.int32)
    return types.SimpleNamespace(a_mono_tuples=monos, a_mono_bits=bits,
                                 n_a_planes=len(monos))


def _program(kind):
    if kind == "full92":
        return _all_monomials()
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


@pytest.mark.parametrize("kind", ["exact", "sampled", "full92"])
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


@pytest.mark.parametrize("kind", ["exact", "sampled", "full92"])
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


def test_kernel_takes_every_8_bit_program():
    """The kernel's monomial table holds every plane an 8-bit program can
    have, and its arguments (4 pointers, 6 ints, the table of MAX_MONOS x
    3 shifts) stay far inside the 4 KB kernel parameter space."""
    assert tem.MAX_MONOS == _all_monomials().n_a_planes == 92
    assert 4 * 8 + 6 * 4 + 3 * tem.MAX_MONOS <= 4096


def test_cpu_tensors_never_count_as_launches():
    prog, x, wt, bias = _case("exact", 3, 32, 16)
    before = tem.encoded_matmul.launches
    _port(prog, x, wt, bias)
    assert tem.encoded_matmul.launches == before


@pytest.mark.parametrize("m,k,n", [(1, 1024, 2816), (33, 100, 70),
                                   (4, 2816, 1024)])
def test_split_k_covers_k(m, k, n):
    """The splits of the (u, k) axis cover every chunk exactly once: split
    z takes chunks [z · per, (z + 1) · per), none of them empty."""
    p = tem.plan(m, k, n, 8, sms=132)
    assert p.chunks == 8 * -(-k // tem.KC) and p.splits >= 1
    assert (p.splits - 1) * p.chunks_per_split < p.chunks \
        <= p.splits * p.chunks_per_split


def _covered(p, U, k):
    """(u, k) pairs in the order the kernel's sums meet them."""
    out = []
    for b, e in tem.chunk_runs(p):
        for j in range(b, e):
            u, kc = tem.chunk_uk(j, U)
            out += [(u, kk) for kk in range(kc * tem.KC,
                                            min(k, (kc + 1) * tem.KC))]
    return out


@pytest.mark.parametrize("U", [8, 48, 92])
@pytest.mark.parametrize("n", [70, 1024, 2816])
@pytest.mark.parametrize("k", [130, 1024, 2816])
@pytest.mark.parametrize("m", [1, 4, 32, 33, 100])
def test_plan_covers_every_uk_once_in_fixed_order(m, k, n, U):
    """Main-path and ragged shapes: the (split, warp) runs are contiguous
    and ascending, so every (u, k) is summed exactly once and in one fixed
    order; the plan's shared memory fits a block and its tile is an N the
    MMA takes."""
    p = tem.plan(m, k, n, U, sms=132)
    runs = tem.chunk_runs(p)
    assert len(runs) == p.splits * tem.WARPS
    pos = 0
    for b, e in runs:
        assert b <= e and (b == e or b == pos)
        pos = max(pos, e)
    assert pos == p.chunks
    seen = _covered(p, U, k)
    assert len(seen) == U * k and len(set(seen)) == U * k
    assert seen == _covered(tem.plan(m, k, n, U, sms=132), U, k)
    assert 3 * p.smem_bytes <= tem.SMEM_MAX     # three blocks an SM
    # with each block's static table of MAX_MONOS packed shifts and the
    # 1 KB the card reserves per block, three still fit the SM's 228 KB
    assert 3 * (p.smem_bytes + 4 * tem.MAX_MONOS + 1024) <= 228 * 1024
    assert p.tn in tem.TILE_NS and p.tn % 8 == 0
    assert p.tn * p.passes >= m > p.tn * (p.passes - 1)
    assert p.n_tiles * tem.BN >= n and p.stages >= 3
    assert 1 <= p.splits <= tem.MAX_SPLITS


@pytest.mark.parametrize("m,tn", [(1, 8), (4, 8), (8, 8), (9, 16), (16, 16),
                                  (17, 32), (32, 32), (33, 32), (100, 32)])
def test_tile_n_pads_m_to_an_mma_width(m, tn):
    assert tem.tile_n(m) == tn


@pytest.mark.parametrize("k,n", [(1024, 1024), (1024, 2816), (2816, 1024)])
def test_decode_plan_fills_the_card(k, n):
    """At decode (m = 4, U = 8) the grid holds at least 128 blocks, one for
    97% of an H100's 132 SMs, and three blocks' rings fit an SM."""
    p = tem.plan(4, k, n, 8, sms=132)
    assert p.n_tiles * p.splits >= 128 and 3 * p.smem_bytes <= tem.SMEM_MAX
