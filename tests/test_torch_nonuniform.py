"""Port parity: non-uniform and uniform levels (``repro_torch.quant``:
``kmeans_levels``, ``nonuniform_codes``, ``map_levels_to_int8``,
``uniform_levels``) against the JAX package, on the CPU.

Tolerances: a cluster's sum is an f32 product summed in another order
than XLA's, so levels agree within 1e-6·max|x| (measured: a few ulps);
codes are equal but where a value lies at the midpoint of two levels
within that tolerance, where the two orders may pick either level."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.quant import kmeans_levels as j_kmeans  # noqa: E402
from repro.quant import map_levels_to_int8 as j_map  # noqa: E402
from repro.quant import nonuniform_codes as j_codes  # noqa: E402
from repro.quant import uniform_levels as j_uniform  # noqa: E402

from repro_torch.quant import kmeans_levels as t_kmeans  # noqa: E402
from repro_torch.quant import map_levels_to_int8 as t_map  # noqa: E402
from repro_torch.quant import nonuniform_codes as t_codes  # noqa: E402
from repro_torch.quant import uniform_levels as t_uniform  # noqa: E402

LEVEL_TOL = 1e-6        # times max|x|
# the reference's k-means under ``jax.jit``, compiled once a shape and
# width (called eagerly, its scan compiles on every call)
_j_kmeans_jit = jax.jit(j_kmeans, static_argnames=("bits",))


def _values(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":                 # a conv layer's weights
        return (rng.normal(size=(27, 16)) / np.sqrt(27)).astype(np.float32)
    if kind == "heavy":                  # heavy tails: sparse outer clusters
        return rng.standard_t(2, size=(64, 40)).astype(np.float32)
    # few distinct values: most of 16 clusters stay empty and keep their
    # centres
    return rng.integers(-2, 3, size=(200,)).astype(np.float32) * 0.25


def _both(x, bits):
    jl = np.array(_j_kmeans_jit(jnp.asarray(x), bits=bits))
    tl = t_kmeans(torch.from_numpy(x), bits=bits).numpy()
    return jl, tl


@pytest.mark.parametrize("kind", ["normal", "heavy", "few"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("bits", [3, 4])
def test_kmeans_levels_match_reference(kind, seed, bits):
    x = _values(kind, seed)
    jl, tl = _both(x, bits)
    assert tl.dtype == np.float32 and tl.shape == (1 << bits,)
    assert np.all(np.diff(tl) >= 0)
    tol = LEVEL_TOL * np.abs(x).max()
    assert np.abs(jl - tl).max() <= tol, (jl, tl)
    # numpy input (Fig 7 passes the net's weights as one array)
    assert np.array_equal(t_kmeans(x, bits=bits).numpy(), tl)


@pytest.mark.parametrize("kind", ["normal", "heavy", "few"])
@pytest.mark.parametrize("bits", [3, 4])
def test_codes_match_reference_but_at_midpoints(kind, bits):
    x = _values(kind, 7)
    jl, tl = _both(x, bits)
    # from the same levels: equal, ties to the first level as jnp.argmin
    same = t_codes(torch.from_numpy(x), torch.from_numpy(jl)).numpy()
    assert same.dtype == np.int8
    assert np.array_equal(same, np.asarray(j_codes(jnp.asarray(x),
                                                   jnp.asarray(jl))))
    # each package with its own levels: apart only at a midpoint
    jc = np.array(j_codes(jnp.asarray(x), jnp.asarray(jl)))
    tc = t_codes(torch.from_numpy(x), torch.from_numpy(tl)).numpy()
    tol = LEVEL_TOL * np.abs(x).max()
    for i in np.flatnonzero(jc.reshape(-1) != tc.reshape(-1)):
        v = x.reshape(-1)[i]
        a, b = sorted((int(jc.reshape(-1)[i]), int(tc.reshape(-1)[i])))
        assert b == a + 1
        assert abs(v - (jl[a] + jl[b]) / 2) <= 2 * tol


def test_tie_takes_the_first_level():
    levels = torch.tensor([-1.0, 0.0, 1.0])
    x = torch.tensor([-0.5, 0.5, 0.0])
    assert t_codes(x, levels).tolist() == [0, 1, 1]


@pytest.mark.parametrize("bits", [4, 8])
def test_map_levels_and_uniform_levels_equal_reference(bits):
    rng = np.random.default_rng(bits)
    levels = np.sort(rng.normal(size=16)).astype(np.float32)
    levels[3] = 2.5 * 0.01                      # a .5 rounding tie
    for scale in (0.01, 0.1, np.float32(np.abs(levels).max() / 127)):
        j = np.asarray(j_map(jnp.asarray(levels), jnp.float32(scale), bits))
        t = t_map(torch.from_numpy(levels),
                  torch.tensor(scale, dtype=torch.float32), bits).numpy()
        assert t.dtype == np.int8 and np.array_equal(j, t)
    assert np.array_equal(np.asarray(j_uniform(bits)), t_uniform(bits).numpy())
    assert t_uniform(bits).dtype == torch.float32
