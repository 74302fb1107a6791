"""Port parity for the quantized paged KV pools (int8, packed int4): the
quantizer and the int4 packing bit for bit against ``repro.quant.kvcache``;
quantize-on-scatter pools and scale pools bit for bit; the fused op's
plain version (the path CPU tensors take) against the reference's blocked
lowering and its Pallas kernel in interpret mode at rtol 2e-5, atol 2e-6
(tests/test_kv_quant.py); the reduced-qwen ``Engine`` replayed through
both packages with int8 and int4 pools; and the pool byte accounting."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.kernels.paged_attention import paged_attn as j_paged_attn  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.nn import paged as jpaged  # noqa: E402
from repro.quant import kvcache as jkv  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.kernels import paged_attention as tpa  # noqa: E402
from repro_torch.models import init_paged_cache as t_init_paged  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.nn import paged as tpaged  # noqa: E402
from repro_torch.quant import kvcache as tkv  # noqa: E402
from repro_torch.serve import (Engine as TEngine, exact_encodings,  # noqa: E402
                               prepare_encoded_serving)

TOL = dict(rtol=2e-5, atol=2e-6)
MODES = ("int8", "int4")


def _rows(seed, shape, zero_rows=True):
    x = (np.random.default_rng(seed).normal(size=shape) * 3).astype(
        np.float32)
    if zero_rows:
        x[0] = 0.0                   # all-zero rows: scale 0, codes 0
        x[..., 1, :] = 0.0
    return x


# ---------------------------------------------------------------------------
# quantizer and packing, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 5, 2, 16), (7, 4, 64)])
def test_pack_unpack_int4_match_reference(shape):
    lv = np.random.default_rng(0).integers(-7, 8, size=shape).astype(np.int8)
    packed = tkv.pack_int4(torch.from_numpy(lv))
    ref = np.asarray(jkv.pack_int4(jnp.asarray(lv)))
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(), ref)
    np.testing.assert_array_equal(tkv.unpack_int4(packed).numpy(),
                                  np.asarray(jkv.unpack_int4(
                                      jnp.asarray(ref))))
    np.testing.assert_array_equal(tkv.unpack_int4(packed).numpy(),
                                  lv.astype(np.float32))
    # zero bytes (never written) decode to -8
    zero = tkv.unpack_int4(torch.zeros((2, 4), dtype=torch.uint8))
    assert (zero == -8.0).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(4, 3, 2, 32), (5, 8, 16)])
def test_quantize_dequantize_match_reference(mode, shape):
    x = _rows(hash((mode, shape)) % 2 ** 32, shape)
    q, s = tkv.quantize_kv(torch.from_numpy(x), mode)
    jq, js = jkv.quantize_kv(jnp.asarray(x), mode)
    assert q.dtype == (torch.int8 if mode == "int8" else torch.uint8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tkv.dequantize_kv(q, s, mode)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jkv.dequantize_kv(jq, js, mode)))
    np.testing.assert_array_equal(back[0].numpy(), 0.0)


def test_kv_mode_classifier_and_dense_mode_refused():
    assert tkv.kv_mode_of(torch.zeros(2, dtype=torch.int8)) == "int8"
    assert tkv.kv_mode_of(torch.zeros(2, dtype=torch.uint8)) == "int4"
    assert tkv.kv_mode_of(torch.zeros(2, dtype=torch.bfloat16)) == "bf16"
    assert tkv.kv_mode_of(torch.float32) == "bf16"
    assert tkv.KV_DTYPES == jkv.KV_DTYPES and tkv._EPS == jkv._EPS
    with pytest.raises(ValueError, match="dense"):
        tkv.quantize_kv(torch.zeros(2, 4), "bf16")
    with pytest.raises(ValueError, match="dense"):
        tkv.dequantize_kv(torch.zeros(2, 4), torch.zeros(2), "bf16")


# ---------------------------------------------------------------------------
# quantize-on-scatter and the dequantizing gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_scatter_kv_quant_matches_reference(mode):
    """Two writes through shuffled page tables, one running past the table
    (→ scratch page 0): value pools and scale pools bit for bit, and the
    dequantizing gather equal."""
    ps, P, H, D, n_pages = 4, 3, 2, 16, 8
    Dp = D // 2 if mode == "int4" else D
    pdt = np.int8 if mode == "int8" else np.uint8
    pool = np.zeros((n_pages, ps, H, Dp), pdt)
    scale = np.zeros((n_pages, ps, H), np.float32)
    pages = np.asarray([[3, 1, 6], [2, 7, 0]], np.int32)
    tpool, tscale = torch.from_numpy(pool.copy()), torch.from_numpy(
        scale.copy())
    jpool, jscale = jnp.asarray(pool), jnp.asarray(scale)
    for step, (start, S) in enumerate(((0, 6), (6, 8))):
        val = _rows(10 + step, (2, S, H, D), zero_rows=False)
        val[1, 0] = 0.0
        pos = start + np.arange(S, dtype=np.int32)[None].repeat(2, 0)
        tpaged.scatter_kv_quant(tpool, tscale, torch.from_numpy(pages),
                                torch.from_numpy(pos), torch.from_numpy(val))
        jpool, jscale = jpaged.scatter_kv_quant(
            jpool, jscale, jnp.asarray(pages), jnp.asarray(pos),
            jnp.asarray(val))
    # every real page bit for bit (scratch page 0 takes colliding writes
    # in an order neither package defines, and is never read unmasked)
    np.testing.assert_array_equal(tpool.numpy()[1:], np.asarray(jpool)[1:])
    np.testing.assert_array_equal(tscale.numpy()[1:], np.asarray(jscale)[1:])
    assert tpool[1:].any()
    real = pages[:1]
    np.testing.assert_array_equal(
        tpaged.gather_kv_dequant(tpool, tscale,
                                 torch.from_numpy(real)).numpy(),
        np.asarray(jpaged.gather_kv_dequant(jpool, jscale,
                                            jnp.asarray(real))))


# ---------------------------------------------------------------------------
# the fused op on quantized pools
# ---------------------------------------------------------------------------

def _case(seed, mode, B, Sq, Hq, Hkv, D, ps, P):
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * P
    dense = [rng.normal(size=(n_pages, ps, Hkv, D)).astype(np.float32)
             for _ in range(2)]
    pages = np.zeros((B, P), np.int32)
    for b in range(B):               # shuffled page chains
        pages[b] = 1 + b * P + rng.permutation(P)
    g = max(1, Hq // Hkv)
    kv_map = np.minimum(np.arange(Hq) // g, Hkv - 1).astype(np.int32)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    pk, sk = (np.array(a) for a in jkv.quantize_kv(jnp.asarray(dense[0]),
                                                   mode))
    pv, sv = (np.array(a) for a in jkv.quantize_kv(jnp.asarray(dense[1]),
                                                   mode))
    return q, pk, pv, sk, sv, pages, kv_map


def _both(backend, q, pk, pv, sk, sv, pages, lens, kv_map, **kw):
    t = torch.from_numpy
    out = tpa.paged_attn(t(q), t(pk), t(pv), t(pages), t(lens),
                         kv_of_q=kv_map, scale_k=t(sk), scale_v=t(sv),
                         **kw).numpy()
    ref = np.asarray(j_paged_attn(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(pages),
        jnp.asarray(lens), kv_of_q=kv_map, backend=backend,
        scale_k=jnp.asarray(sk), scale_v=jnp.asarray(sv), **kw))
    return out, ref


HEADS = [(4, 4), (4, 2), (4, 1)]           # MHA, GQA, MQA


@pytest.mark.parametrize("backend", ["blocked", "pallas_interpret"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ps", [4, 8])
@pytest.mark.parametrize("Hq,Hkv", HEADS)
def test_quant_op_matches_reference_lens_sweep(backend, mode, ps, Hq, Hkv):
    """Ragged lens around the page boundaries and near the table end."""
    P, D = 4, 16
    lens = np.asarray([0, 1, ps - 1, ps, ps + 1, P * ps - 1], np.int32)
    case = _case(ps + Hq + Hkv, mode, len(lens), 1, Hq, Hkv, D, ps, P)
    q, pk, pv, sk, sv, pages, kv_map = case
    out, ref = _both(backend, q, pk, pv, sk, sv, pages, lens, kv_map,
                     scale=1.0 / np.sqrt(D))
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("backend", ["blocked", "pallas_interpret"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("Sq,window,cap", [(1, 7, 30.0), (2, None, 20.0),
                                           (3, 6, None)])
def test_quant_op_matches_reference_window_softcap_sq(backend, mode, Sq,
                                                      window, cap):
    ps, P, D = 8, 5, 32
    lens = np.asarray([0, ps + 3, 3 * ps, P * ps - Sq], np.int32)
    q, pk, pv, sk, sv, pages, kv_map = _case(11 + Sq, mode, len(lens), Sq,
                                             4, 2, D, ps, P)
    out, ref = _both(backend, q, pk, pv, sk, sv, pages, lens, kv_map,
                     scale=1.0 / np.sqrt(D), window=window, cap=cap)
    np.testing.assert_allclose(out, ref, **TOL)


def test_scales_come_with_quantized_pools_only():
    q, pk, pv, sk, sv, pages, kv_map = _case(0, "int8", 2, 1, 4, 2, 8, 4, 2)
    t = torch.from_numpy
    lens = t(np.asarray([1, 3], np.int32))
    with pytest.raises(ValueError, match="scale_k"):
        tpa.paged_attn(t(q), t(pk), t(pv), t(pages), lens, scale=1.0,
                       kv_of_q=kv_map)
    dense = torch.zeros(pk.shape, dtype=torch.float32)
    with pytest.raises(ValueError, match="scale_k"):
        tpa.paged_attn(t(q), dense, dense, t(pages), lens, scale=1.0,
                       kv_of_q=kv_map, scale_k=t(sk), scale_v=t(sv))


# ---------------------------------------------------------------------------
# cache layout, accounting and the config guards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8", "int4"])
def test_paged_cache_layout_matches_reference(kv_dtype):
    from repro.models import init_paged_cache as j_init_paged
    jcfg = dataclasses.replace(jget("qwen1.5-0.5b").reduced(),
                               kv_cache_dtype=kv_dtype)
    tcfg = dataclasses.replace(tget("qwen1.5-0.5b").reduced(),
                               kv_cache_dtype=kv_dtype)
    jl = j_init_paged(jcfg, 9, 4)["layers"]["stack"]
    tl = t_init_paged(tcfg, 9, 4, device="cpu")["layers"]
    assert len(tl) == tcfg.n_layers
    assert sorted(tl[0]) == sorted(jl)
    for name, leaf in jl.items():
        assert tuple(tl[0][name].shape) == leaf.shape[1:]
        assert str(tl[0][name].dtype).split(".")[-1] == str(leaf.dtype)


def test_int4_requires_even_head_dim():
    cfg = dataclasses.replace(tget("qwen1.5-0.5b").reduced(), head_dim=33,
                              kv_cache_dtype="int4")
    with pytest.raises(ValueError, match="even"):
        t_init_paged(cfg, 8, 4, device="cpu")


def test_unknown_kv_dtype_rejected():
    cfg = dataclasses.replace(tget("qwen1.5-0.5b").reduced(),
                              kv_cache_dtype="fp8")
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        t_init_paged(cfg, 8, 4, device="cpu")


# ---------------------------------------------------------------------------
# the engine, replayed through both packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    jcfg = jget("qwen1.5-0.5b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    override = {n: mac for n in ("wq", "wk", "wv", "wo", "wi", "wg", "w")}
    jpe, jce, _ = j_prepare(jp, jcfg, macs_override=override,
                            cache_dir=str(tmp_path_factory.mktemp("b")),
                            verbose=False)
    tcfg = tget("qwen1.5-0.5b").reduced()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    # the port calibrates and folds on its own, as tests/test_torch_serve.py
    tpe, tce, _ = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(), device="cpu",
        cache_dir=str(tmp_path_factory.mktemp("own")), verbose=False)
    return {"fp": ((jp, jcfg), (tp, tcfg)),
            "encoded": ((jpe, jce), (tpe, tce))}


def _trace():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (40, 13, 35, 7, 50)]


def _state(eng):
    reqs = tuple((rid, r.state, r.slot, r.n_cached, tuple(r.pages),
                  tuple(r.out), r.n_evictions)
                 for rid, r in sorted(eng.requests.items()))
    slots = tuple(None if r is None else r.rid for r in eng.sched.slots)
    return reqs, slots, eng.sched.n_evictions


@pytest.mark.parametrize("kv_dtype", MODES)
@pytest.mark.parametrize("mode,backend", [("fp", "kernel"),
                                          ("encoded", "gather"),
                                          ("encoded", "kernel")])
def test_quant_trace_replay_matches_reference(models, kv_dtype, mode,
                                              backend):
    """Optimistic reserve over a pool that forces an eviction, prompts
    longer than one prefill chunk: admissions, page tables, lens and the
    scale pools after every step, and greedy tokens token for token."""
    (jp, jcfg), (tp, tcfg) = models[mode]
    jcfg = dataclasses.replace(
        jcfg, kv_cache_dtype=kv_dtype,
        attention_backend="xla" if backend == "gather" else "pallas")
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv_dtype,
                               attention_backend=backend)
    kw = dict(n_slots=3, page_size=8, n_pages=13, max_seq_pages=12,
              reserve="optimistic", prefill_chunk=32)
    je = JEngine(jp, jcfg, **kw)
    te = TEngine(tp, tcfg, device="cpu", **kw)
    for p in _trace():
        assert je.submit(p, max_new=16) == te.submit(p, max_new=16)
    steps = 0
    while je.busy or te.busy:
        je.step()
        te.step()
        steps += 1
        assert _state(te) == _state(je), f"step {steps}"
        np.testing.assert_array_equal(te.kv.ptab, je.kv.ptab)
        np.testing.assert_array_equal(te.kv.lens, je.kv.lens)
        assert steps < 500
    assert te.stats()["evictions"] == je.stats()["evictions"] >= 1
    jr, tr = je.results(), te.results()
    assert sorted(jr) == sorted(tr) == list(range(5))
    for rid in jr:
        assert tr[rid].tolist() == jr[rid].tolist(), rid
    # the scale rows the last step left in the pools (fp mode: the same
    # weights and f32 ops, so the same bytes up to the f32 sum order)
    jst = je.kv.layers["stack"]
    for i, layer in enumerate(te.kv.layers):
        np.testing.assert_allclose(layer["scale_k"].numpy(),
                                   np.asarray(jst["scale_k"][i]),
                                   rtol=1e-4, atol=1e-6)


def test_quant_engine_accounting_matches_reference(models):
    (jp, jcfg), (tp, tcfg) = models["fp"]
    kw = dict(n_slots=2, page_size=4, n_pages=32, prefill_chunk=8)
    got = {}
    for kvd in ("bf16", "int8", "int4"):
        je = JEngine(jp, dataclasses.replace(jcfg, kv_cache_dtype=kvd), **kw)
        te = TEngine(tp, dataclasses.replace(tcfg, kv_cache_dtype=kvd),
                     device="cpu", **kw)
        js, ts = je.stats(), te.stats()
        for key in ("kv_pool_bytes", "kv_bytes_per_token",
                    "kv_capacity_tokens", "kv_cache_dtype"):
            assert ts[key] == js[key], (kvd, key)
        assert te.kv.pool_bytes() == je.kv.pool_bytes()
        got[kvd] = ts["kv_bytes_per_token"]
    assert got["int4"] < got["int8"] < got["bf16"]
