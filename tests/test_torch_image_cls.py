"""Port parity: the paper's conv-net path (``repro_torch.core.layers``'
dense and conv layers, ``repro_torch.apps.image_cls``,
``repro_torch.data.synthetic_images``) against the JAX package, on the
CPU, in fp, int8 and the encoded MAC (the exact encoding and a small
encoding searched by the reference, carried across).

The reference's eager functions run under ``jax.jit`` here (the same
values, one compile instead of one per op).

Tolerances: the images and the conv patches are equal bit for bit (the
patches are copies); a layer's output is an f32 product summed in
another order than XLA's, within 1e-5·max|ref| (measured: at most
5.3e-7); calibrated scales are a max over such outputs, within rtol 1e-5
(measured: 1.3e-6); after 4 AdamW steps at lr 3e-3 the params within
2e-3 (measured: 2.0e-5, where Adam's first steps divide by a small second
moment); fine-tuned position weights within 1e-5·max|s| (measured:
4.4e-8); k-means weights
within 1e-6·max|w| but where a weight lies at a midpoint of two levels
(``tests/test_torch_nonuniform.py``)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.apps import image_cls as J  # noqa: E402
from repro.core import layers as JL  # noqa: E402
from repro.core.circuits import exact_product_circuit as j_exact  # noqa: E402
from repro.core.encoding import EncodingSpec as JSpec  # noqa: E402
from repro.core.mac import EncodedMac as JMac  # noqa: E402
from repro.core.search import random_search as j_search  # noqa: E402
from repro.data.synthetic import synthetic_images as j_images  # noqa: E402

from repro_torch.apps import image_cls as T  # noqa: E402
from repro_torch.core import layers as TL  # noqa: E402
from repro_torch.core.circuits import Circuit as TCircuit  # noqa: E402
from repro_torch.core.encoding import EncodingSpec as TSpec  # noqa: E402
from repro_torch.core.mac import EncodedMac as TMac  # noqa: E402
from repro_torch.data import synthetic_images as t_images  # noqa: E402

OUT_RTOL = 1e-5          # times max|ref|
SCALE_RTOL = 1e-5
PARAM_ATOL = 2e-3
S_RTOL = 1e-5            # times max|s|
LEVEL_TOL = 1e-6         # times max|w|


def carry_mac(jmac):
    """The reference's encoding as the port's (circuit, s, RMSE)."""
    c = jmac.spec.circuit
    circ = TCircuit(np.asarray(c.gate_types), np.asarray(c.in_idx),
                    c.bits_a, c.bits_b)
    return TMac.from_spec(TSpec(circ, np.asarray(jmac.spec.s, np.float32),
                                float(jmac.spec.rmse)))


def encodings():
    """{"exact": (reference mac, port mac), "searched24": ...}: the exact
    AND-plane encoding, and an M = 24 encoding the reference's search
    picks from 64 samples."""
    circ, s = j_exact(8, 8)
    exact = JMac.from_spec(JSpec(circ, s, 0.0))
    res = j_search(seed=5, m_bits=24, n_samples=64)
    searched = JMac.from_spec(res.spec)
    return {"exact": (exact, carry_mac(exact)),
            "searched24": (searched, carry_mac(searched))}


@pytest.fixture(scope="module")
def macs():
    return encodings()


_REF_CAL = {}


def ref_calibrate(params, imgs, jc, n):
    """The reference's calibrated params, computed once for each
    (params, images, mode, encoding, n) that the tests share."""
    key = (id(params), id(imgs), jc.mode, id(jc.mac), n)
    if key not in _REF_CAL:
        _REF_CAL[key] = jax.jit(functools.partial(J.calibrate, mcfg=jc,
                                                  n=n))(
            J.convert_params(jax.tree_util.tree_map(jnp.asarray, params),
                             jc), jnp.asarray(imgs))
    return _REF_CAL[key]


def cfgs(mode, macs, enc=None):
    jm, tm = macs[enc] if enc else (None, None)
    return JL.MacConfig(mode=mode, mac=jm), TL.MacConfig(mode=mode, mac=tm)


def to_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def close(ref, got, rtol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape
    err = np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, err


@pytest.mark.parametrize("n,size,seed", [(40, 16, 0), (25, 8, 3),
                                         (10, 16, 11)])
def test_synthetic_images_bit_for_bit(n, size, seed):
    ji, jl = j_images(n, size=size, seed=seed)
    ti, tl = t_images(n, size=size, seed=seed)
    assert ti.dtype == ji.dtype and tl.dtype == jl.dtype
    assert np.array_equal(ji, ti) and np.array_equal(jl, tl)


@pytest.mark.parametrize("c_in", [3, 5])
@pytest.mark.parametrize("size", [16, 8, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_matches_reference(stride, size, c_in):
    """SAME padding at stride 2 pads (0, 1) on even sizes, and the
    patches' features are (kh, kw, c): the patches equal the
    reference's bit for bit, the conv's output within OUT_RTOL."""
    rng = np.random.default_rng(100 * size + 10 * stride + c_in)
    x = rng.random((2, size, size, c_in)).astype(np.float32)
    w = (rng.normal(size=(9 * c_in, 6)) / np.sqrt(9 * c_in)).astype(
        np.float32)
    patches = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (3, 3), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    n, ph, pw, _ = patches.shape
    patches = jnp.swapaxes(patches.reshape(n, ph, pw, c_in, 9), -1, -2)
    got = TL.conv_patches(torch.from_numpy(x), 3, 3, stride).numpy()
    assert np.array_equal(np.asarray(patches).reshape(got.shape), got)
    ref = JL.conv_apply({"w": jnp.asarray(w)}, jnp.asarray(x),
                        JL.MacConfig(), 3, 3, stride=stride)
    out = TL.conv_apply({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                        TL.MacConfig(), 3, 3, stride=stride)
    close(ref, out.numpy(), OUT_RTOL)


@pytest.mark.parametrize("layer", ["dense", "conv_s2"])
@pytest.mark.parametrize("mode,enc", [("int8", None),
                                      ("encoded", "exact"),
                                      ("encoded", "searched24")])
def test_quantized_layers_match_reference(macs, mode, enc, layer):
    """int8 and encoded dense/conv layers from the same weights, each
    package calibrating its own activation scale on the same batch."""
    jc, tc = cfgs(mode, macs, enc)
    rng = np.random.default_rng(7)
    if layer == "dense":
        x = np.maximum(rng.normal(size=(32, 48)), 0).astype(np.float32)
        jp = JL.dense_init(jax.random.PRNGKey(1), 48, 10, jc)
    else:
        x = rng.random((4, 8, 8, 5)).astype(np.float32)
        jp = JL.conv_init(jax.random.PRNGKey(1), 3, 3, 5, 7, jc)
    tp = T.params_from_jax({"l": to_numpy(jp)}, "cpu")["l"]
    assert set(tp) == set(jp)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if layer == "dense":
        jp, tp = JL.calibrate_dense(jp, xj, jc), TL.calibrate_dense(tp, xt,
                                                                    tc)
        ref = jax.jit(functools.partial(JL.dense_apply, cfg=jc))(jp, xj)
        out = TL.dense_apply(tp, xt, tc)
    else:
        jp = JL.calibrate_dense(jp, jax.lax.conv_general_dilated_patches(
            xj, (3, 3), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")), jc)
        tp = TL.calibrate_dense(tp, TL.conv_patches(xt, 3, 3), tc)
        ref = jax.jit(lambda p, x: JL.conv_apply(p, x, jc, 3, 3,
                                                 stride=2))(jp, xj)
        out = TL.conv_apply(tp, xt, tc, 3, 3, stride=2)
    assert float(tp["a_scale"]) == float(jp["a_scale"])
    close(ref, out.numpy(), OUT_RTOL)


@functools.lru_cache(maxsize=None)
def _train_init():
    """The reference's initial params and a batch of images (numpy, read
    only: computed once for the tests that share them)."""
    imgs, labels = j_images(256, seed=0)
    jp = J.cnn_init(jax.random.PRNGKey(0))
    return to_numpy(jp), imgs, labels


CAL_N = 64               # calibration images (the experiments take 256)


@pytest.mark.parametrize("mode,enc", [("int8", None),
                                      ("encoded", "exact"),
                                      ("encoded", "searched24")])
def test_calibrate_scales_match_reference(macs, mode, enc):
    """Each layer's scale through the mode's own forward (an encoded
    forward moves the later layers' scales)."""
    jc, tc = cfgs(mode, macs, enc)
    p0, imgs, _ = _train_init()
    jp = ref_calibrate(p0, imgs, jc, CAL_N)
    tp = T.calibrate(T.convert_params(T.params_from_jax(p0, "cpu"), tc),
                     imgs, tc, n=CAL_N)
    for k in ("c1", "c2", "c3", "d1", "d2"):
        assert set(tp[k]) == set(jp[k])
        close(jp[k]["a_scale"], tp[k]["a_scale"].numpy(), SCALE_RTOL)
        if "s" in jp[k]:
            assert np.array_equal(np.asarray(jp[k]["s"]), tp[k]["s"].numpy())


def test_convert_params_keeps_only_w_in_fp(macs):
    p0, _, _ = _train_init()
    for mode, enc in (("fp", None), ("int8", None), ("encoded", "exact")):
        jc, tc = cfgs(mode, macs, enc)
        jp = J.convert_params(p0, jc)
        tp = T.convert_params(T.params_from_jax(p0, "cpu"), tc)
        assert {k: sorted(v) for k, v in jp.items()} == \
            {k: sorted(v) for k, v in tp.items()}


def test_train_cnn_one_epoch_matches_reference():
    p0, imgs, labels = _train_init()
    fp = JL.MacConfig(mode="fp")
    jp = J.train_cnn(jax.random.PRNGKey(0), imgs, labels, fp, epochs=1)
    losses = []
    tp = T.train_cnn(T.params_from_jax(p0, "cpu"), imgs, labels,
                     TL.MacConfig(mode="fp"), epochs=1, losses=losses)
    assert len(losses) == 256 // 64
    for k in jp:
        ref, got = np.asarray(jp[k]["w"]), tp[k]["w"].numpy()
        assert np.abs(ref - got).max() <= PARAM_ATOL, k
        assert not np.array_equal(got, p0[k]["w"])
    # the reference's logits from the trained params
    x = imgs[:16]
    close(J.cnn_apply(jp, jnp.asarray(x), fp),
          T.cnn_apply(tp, torch.from_numpy(x), TL.MacConfig()).detach(),
          1e-3)


@pytest.mark.parametrize("enc", ["searched24"])
def test_finetune_s_matches_reference(macs, enc):
    jc, tc = cfgs("encoded", macs, enc)
    p0, imgs, labels = _train_init()
    jp = ref_calibrate(p0, imgs, jc, CAL_N)
    tp = T.params_from_jax(to_numpy(jp), "cpu")
    jf = J.finetune_s(jp, imgs, labels, jc, steps=5)
    tf = T.finetune_s(tp, imgs, labels, tc, steps=5)
    for k in jf:
        s0, ref, got = (np.asarray(jp[k]["s"]), np.asarray(jf[k]["s"]),
                        tf[k]["s"].numpy())
        assert not np.array_equal(ref, s0)
        close(ref, got, S_RTOL)
        assert np.array_equal(tf[k]["w"].numpy(), np.asarray(jf[k]["w"]))


def test_nonuniform_to_int8_params_matches_reference():
    p0, _, _ = _train_init()
    jn = jax.jit(J.nonuniform_to_int8_params)(
        jax.tree_util.tree_map(jnp.asarray, p0))
    tn = T.nonuniform_to_int8_params(T.params_from_jax(p0, "cpu"))
    for k in jn:
        w, ref, got = p0[k]["w"], np.asarray(jn[k]["w"]), tn[k]["w"].numpy()
        tol = LEVEL_TOL * np.abs(w).max()
        assert len(np.unique(got)) <= 16
        apart = np.abs(ref - got) > tol
        # a weight at the midpoint of two levels may take either
        assert np.all(np.abs(w[apart] - (ref[apart] + got[apart]) / 2)
                      <= 2 * tol), k
