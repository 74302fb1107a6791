"""Port parity for ``repro_torch.nn.mla`` (multi-head latent attention,
deepseek-v3 reduced: 4 heads, q rank 48, kv rank 32, nope 32, rope 16,
v 32) against ``repro.nn.mla`` on the CPU, from numpy inputs made from a
seed: the no-cache (training) forward, a prefill into the latent cache
(``ckv``, ``kr``) and the decode step after it on both decode paths
(naive and ``mla_absorb``), each against the reference's; the two decode
paths against each other; decode against the no-cache forward of the
whole sequence; and the asymmetry the reference keeps: prefill's
``wk_b``/``wv_b`` are linears under the MAC executor, decode reads the raw
weights in f32.

Tolerances: outputs and caches within rtol 1e-5 / atol 1e-5 (f32
products and the softmax in another order); naive = absorbed and decode =
prefill within 1e-5 (the same sums, regrouped).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.nn import mla as J  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.lm import _convert  # noqa: E402
from repro_torch.nn import mla as T  # noqa: E402
from repro_torch.nn import common as TC  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = dict(rtol=1e-5, atol=1e-5)
S, MAXLEN = 9, 16


def _cfgs(absorb=False):
    return (dataclasses.replace(jget(ARCH).reduced(), mla_absorb=absorb),
            dataclasses.replace(tget(ARCH).reduced(), mla_absorb=absorb))


@pytest.fixture(scope="module")
def setup():
    jc, _ = _cfgs()
    jp = jax.tree_util.tree_map(np.asarray,
                                J.mla_init(jax.random.PRNGKey(0), jc))
    x = np.random.default_rng(1).normal(size=(2, S + 1, jc.d_model)) \
        .astype(np.float32)
    return jp, _convert(jp, torch.device("cpu")), x


def _prefill(jp, tp, x, absorb):
    """Both packages: a prefill of x[:, :S] into a fresh cache."""
    jc, tc = _cfgs(absorb)
    jcache = J.init_mla_cache(jc, 2, MAXLEN, 1)
    jcache = {"ckv": jcache["ckv"][0], "kr": jcache["kr"][0],
              "pos": jcache["pos"]}
    jo, jcache = J.mla_apply(jp, jnp.asarray(x[:, :S]), jc, cache=jcache)
    tcache = dict(T.init_mla_cache(tc, 2, MAXLEN, 1, device="cpu")[0],
                  pos=0)
    with torch.no_grad():
        to, tcache = T.mla_apply(tp, torch.from_numpy(x[:, :S]), tc,
                                 cache=tcache)
    return (jc, jo, jcache), (tc, to, tcache)


def test_no_cache_forward_matches_reference(setup):
    jp, tp, x = setup
    jc, tc = _cfgs()
    jo, jn = J.mla_apply(jp, jnp.asarray(x), jc)
    with torch.no_grad():
        to, tn = T.mla_apply(tp, torch.from_numpy(x), tc)
    assert jn is None and tn is None
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("absorb", [False, True])
def test_prefill_and_decode_match_reference(setup, absorb):
    jp, tp, x = setup
    (jc, jo, jcache), (tc, to, tcache) = _prefill(jp, tp, x, absorb)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    assert int(tcache["pos"]) == int(jcache["pos"]) == S
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(tcache[k].numpy(),
                                   np.asarray(jcache[k]), **TOL)
    jd, jcache = J.mla_apply(jp, jnp.asarray(x[:, S:]), jc, cache=jcache)
    with torch.no_grad():
        td, tcache = T.mla_apply(tp, torch.from_numpy(x[:, S:]), tc,
                                 cache=tcache)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    assert int(tcache["pos"]) == S + 1
    np.testing.assert_allclose(tcache["ckv"].numpy(),
                               np.asarray(jcache["ckv"]), **TOL)


def _decode(jp, tp, x, absorb, pos_tensor=False):
    """The port's decode step for token S after its prefill."""
    _, (tc, _, cache) = _prefill(jp, tp, x, absorb)
    if pos_tensor:
        cache["pos"] = torch.tensor(S, dtype=torch.int32)
    with torch.no_grad():
        out, _ = T.mla_apply(tp, torch.from_numpy(x[:, S:]), tc,
                             cache=cache)
    return out


def test_naive_equals_absorbed_decode(setup):
    naive, absorbed = _decode(*setup, False), _decode(*setup, True)
    np.testing.assert_allclose(absorbed.numpy(), naive.numpy(), **TOL)
    # a device-tensor pos (the captured decode step's) gives the same
    torch.testing.assert_close(_decode(*setup, False, pos_tensor=True),
                               naive, rtol=0, atol=0)


@pytest.mark.parametrize("absorb", [False, True])
def test_decode_equals_prefill(setup, absorb):
    """The decode step's output for token S equals the no-cache forward's
    row S over the whole sequence."""
    _, tp, x = setup
    _, tc = _cfgs(absorb)
    with torch.no_grad():
        full, _ = T.mla_apply(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(_decode(*setup, absorb).numpy(),
                               full[:, S:].numpy(), **TOL)


def test_prefill_linears_and_decode_reads_raw_weights(setup):
    """Prefill calls the ``wk_b``/``wv_b`` linears (so they are encoded
    under 'encoded_infer'); decode calls every linear but those two."""
    _, tp, x = setup
    _, tc = _cfgs()
    names = []
    cache = dict(T.init_mla_cache(tc, 2, MAXLEN, 1, device="cpu")[0],
                 pos=0)
    with torch.no_grad(), TC.activation_recorder(
            lambda n, w, inp: names.append(n)):
        T.mla_apply(tp, torch.from_numpy(x[:, :S]), tc, cache=cache)
        prefill = list(names)
        names.clear()
        T.mla_apply(tp, torch.from_numpy(x[:, S:]), tc, cache=cache)
    assert prefill == ["wq_a", "wq_b", "wkv_a", "wkr", "wk_b", "wv_b", "wo"]
    assert names == ["wq_a", "wq_b", "wkv_a", "wkr", "wo"]
