"""Port parity: the fused paged-attention op's plain PyTorch version (the
path CPU tensors take) against the reference's ``paged_attn`` (the blocked
lowering and the Pallas kernel in interpret mode), and the gather-path
``paged_attn_decode`` against its reference.  Tolerances as the
reference's own tests/test_paged_attention.py: rtol 2e-5, atol 2e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_attn as j_paged_attn  # noqa: E402
from repro.nn.paged import gather_kv as j_gather_kv  # noqa: E402
from repro.nn.paged import paged_attn_decode as j_decode  # noqa: E402

from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.nn.paged import gather_kv as t_gather_kv  # noqa: E402
from repro_torch.nn.paged import paged_attn_decode as t_decode  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-6)


def _case(seed, B, Sq, Hq, Hkv, D, ps, P):
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * P
    pool_k = rng.normal(size=(n_pages, ps, Hkv, D)).astype(np.float32)
    pool_v = rng.normal(size=(n_pages, ps, Hkv, D)).astype(np.float32)
    pages = np.zeros((B, P), np.int32)
    for b in range(B):               # shuffled page chains
        pages[b] = 1 + b * P + rng.permutation(P)
    g = max(1, Hq // Hkv)
    kv_map = np.minimum(np.arange(Hq) // g, Hkv - 1).astype(np.int32)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    return q, pool_k, pool_v, pages, kv_map


def _port(q, pool_k, pool_v, pages, lens, kv_map, **kw):
    out = tpa.paged_attn(torch.from_numpy(q), torch.from_numpy(pool_k),
                         torch.from_numpy(pool_v), torch.from_numpy(pages),
                         torch.from_numpy(lens), kv_of_q=kv_map, **kw)
    return out.numpy()


def _ref(backend, q, pool_k, pool_v, pages, lens, kv_map, **kw):
    return np.asarray(j_paged_attn(
        jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
        jnp.asarray(pages), jnp.asarray(lens), kv_of_q=kv_map,
        backend=backend, **kw))


HEADS = [(4, 4), (4, 2), (4, 1)]           # MHA, GQA, MQA


@pytest.mark.parametrize("backend", ["blocked", "pallas_interpret"])
@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("Hq,Hkv", HEADS)
def test_op_matches_reference_lens_sweep(backend, ps, Hq, Hkv):
    """Ragged lens around the page boundaries and near the table end."""
    P, D = 4, 16
    lens = np.asarray([0, 1, ps - 1, ps, ps + 1, P * ps - 1], np.int32)
    q, pk, pv, pages, kv_map = _case(ps + Hq + Hkv, len(lens), 1, Hq, Hkv,
                                     D, ps, P)
    kw = dict(scale=1.0 / np.sqrt(D))
    np.testing.assert_allclose(
        _port(q, pk, pv, pages, lens, kv_map, **kw),
        _ref(backend, q, pk, pv, pages, lens, kv_map, **kw), **TOL)


@pytest.mark.parametrize("backend", ["blocked", "pallas_interpret"])
@pytest.mark.parametrize("window,cap", [(7, None), (None, 30.0), (9, 20.0)])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (6, 3)])
def test_op_matches_reference_window_softcap(backend, window, cap, Hq, Hkv):
    ps, P, D = 8, 5, 16
    lens = np.asarray([0, ps + 3, 3 * ps, P * ps - 1], np.int32)
    q, pk, pv, pages, kv_map = _case(11, len(lens), 1, Hq, Hkv, D, ps, P)
    kw = dict(scale=1.0 / np.sqrt(D), window=window, cap=cap)
    np.testing.assert_allclose(
        _port(q, pk, pv, pages, lens, kv_map, **kw),
        _ref(backend, q, pk, pv, pages, lens, kv_map, **kw), **TOL)


@pytest.mark.parametrize("backend", ["blocked", "pallas_interpret"])
@pytest.mark.parametrize("Sq", [2, 3])
def test_op_multi_query_rows_match_reference(backend, Sq):
    """Sq > 1 query tokens per row fold into the group axis (s·G + g)."""
    ps, P, D = 8, 4, 16
    lens = np.asarray([0, 5, ps, P * ps - Sq], np.int32)
    q, pk, pv, pages, kv_map = _case(21 + Sq, len(lens), Sq, 4, 2, D, ps, P)
    kw = dict(scale=1.0 / np.sqrt(D), window=6, cap=25.0)
    np.testing.assert_allclose(
        _port(q, pk, pv, pages, lens, kv_map, **kw),
        _ref(backend, q, pk, pv, pages, lens, kv_map, **kw), **TOL)


def test_op_bf16_pools_match_reference():
    ps, P, D = 8, 4, 16
    lens = np.asarray([0, 9, 31], np.int32)
    q, pk, pv, pages, kv_map = _case(5, len(lens), 1, 4, 2, D, ps, P)
    import ml_dtypes
    to_bf = lambda a: a.astype(ml_dtypes.bfloat16)       # noqa: E731
    kw = dict(scale=1.0 / np.sqrt(D))
    ref = _ref("blocked", to_bf(q), to_bf(pk), to_bf(pv), pages, lens,
               kv_map, **kw).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    out = tpa.paged_attn(t(q), t(pk), t(pv), torch.from_numpy(pages),
                         torch.from_numpy(lens), kv_of_q=kv_map, **kw)
    assert out.dtype == torch.bfloat16
    # both round the output to bf16 once: at most one bf16 ulp apart
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=8e-3,
                               atol=1e-6)


def test_gqa_group_and_irregular_maps():
    assert tpa.gqa_group(np.arange(4), 4, 4) == 1
    assert tpa.gqa_group(np.asarray([0, 0, 1, 1]), 4, 2) == 2
    assert tpa.gqa_group(np.asarray([0, 1, 0, 1]), 4, 2) is None
    q, pk, pv, pages, _ = _case(0, 2, 1, 4, 2, 8, 4, 2)
    with pytest.raises(ValueError):
        _port(q, pk, pv, pages, np.zeros(2, np.int32),
              np.asarray([0, 1, 0, 1]), scale=1.0)
    with pytest.raises(ValueError):          # Sq above the fold bound
        q_big = np.zeros((2, tpa.MAX_SQ + 1, 4, 8), np.float32)
        _port(q_big, pk, pv, pages, np.zeros(2, np.int32), None, scale=1.0)


@pytest.mark.parametrize("window,cap", [(None, None), (5, 30.0)])
@pytest.mark.parametrize("Hq,Hkv", HEADS)
def test_gather_path_matches_reference(window, cap, Hq, Hkv):
    """``nn.paged.paged_attn_decode`` over the gathered page view, with a
    prefill-like Sq and per-row offsets."""
    ps, P, D, Sq = 4, 4, 8, 3
    lens = np.asarray([0, 5, 13], np.int32)
    q, pk, pv, pages, kv_map = _case(7, len(lens), Sq, Hq, Hkv, D, ps, P)
    q_pos = lens[:, None] + np.arange(Sq)[None, :]
    k_pos = np.arange(P * ps)
    k_valid = k_pos[None, :] < (lens + Sq)[:, None]
    kw = dict(scale=1.0 / np.sqrt(D), window=window, cap=cap)
    ck = np.asarray(j_gather_kv(jnp.asarray(pk), jnp.asarray(pages)))
    cv = np.asarray(j_gather_kv(jnp.asarray(pv), jnp.asarray(pages)))
    tck = t_gather_kv(torch.from_numpy(pk), torch.from_numpy(pages))
    tcv = t_gather_kv(torch.from_numpy(pv), torch.from_numpy(pages))
    np.testing.assert_array_equal(tck.numpy(), ck)
    ref = np.asarray(j_decode(jnp.asarray(q), jnp.asarray(ck),
                              jnp.asarray(cv), kv_map,
                              q_pos=jnp.asarray(q_pos),
                              k_pos=jnp.asarray(k_pos),
                              k_valid=jnp.asarray(k_valid), **kw))
    out = t_decode(torch.from_numpy(q), tck, tcv, kv_map,
                   q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos),
                   k_valid=torch.from_numpy(k_valid), **kw).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


def test_cpu_tensors_never_count_as_launches():
    q, pk, pv, pages, kv_map = _case(0, 2, 1, 4, 2, 8, 4, 2)
    before = tpa.paged_attn.launches
    _port(q, pk, pv, pages, np.asarray([1, 3], np.int32), kv_map, scale=1.0)
    assert tpa.paged_attn.launches == before
