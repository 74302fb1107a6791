"""Port parity for the dense decoder: the param bridge, full-forward
logits in fp and encoded_infer modes, paged prefill + decode through the
gather path and the fused gate, and the port's own calibration and fold
(reduced qwen1.5-0.5b: 2 layers, d = 128).  Logits within rtol/atol 1e-4;
calibration amax within rtol 1e-6; folded weights exact."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core.circuits import exact_product_circuit  # noqa: E402
from repro.core.encoding import EncodingSpec  # noqa: E402
from repro.core.mac import EncodedMac  # noqa: E402
from repro.models import apply_model as j_apply  # noqa: E402
from repro.models import init_model as j_init  # noqa: E402
from repro.models import init_paged_cache as j_init_paged  # noqa: E402
from repro.serve.encoded import prepare_encoded_serving as j_prepare  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core.layers import MacConfig  # noqa: E402
from repro_torch.models import apply_model as t_apply  # noqa: E402
from repro_torch.models import init_model as t_init  # noqa: E402
from repro_torch.models import init_paged_cache as t_init_paged  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve.encoded import (capture_activation_stats,  # noqa: E402
                                       exact_encodings,
                                       prepare_encoded_serving)

TOL = dict(rtol=1e-4, atol=1e-4)
FAMS = (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wg", "wo")))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Reference fp params and their encoded-exact serving pair."""
    cfg = jget("qwen1.5-0.5b").reduced()
    params = j_init(jax.random.PRNGKey(0), cfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    override = {n: mac for n in ("wq", "wk", "wv", "wo", "wi", "wg", "w")}
    p_enc, c_enc, _ = j_prepare(params, cfg, macs_override=override,
                                cache_dir=str(tmp_path_factory.mktemp("b")),
                                verbose=False)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return cfg, params, to_np(params), c_enc, p_enc, to_np(p_enc)


@pytest.fixture(scope="module")
def port(ref):
    _, _, tree, _, _, tree_enc = ref
    cfg = tget("qwen1.5-0.5b").reduced()
    cfg_enc = dataclasses.replace(
        cfg, mac=MacConfig(mode="encoded_infer", macs=exact_encodings()))
    return (cfg, params_from_jax(tree, cfg, "cpu"), cfg_enc,
            params_from_jax(tree_enc, cfg, "cpu"))


def _pairs(ref, port, mode):
    jcfg, jp, _, jce, jpe, _ = ref
    tcfg, tp, tce, tpe = port
    return (jce, jpe, tce, tpe) if mode == "encoded" else (jcfg, jp, tcfg, tp)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_bridge_leaves_unchanged(ref, port):
    _, _, tree, _, _, _ = ref
    _, tp, _, _ = port
    stack = tree["stack"]
    n = 0
    for name, leaf in _flat({k: v for k, v in tree.items() if k != "stack"}):
        node = tp
        for part in name.split("/"):
            node = node[part]
        np.testing.assert_array_equal(node.numpy(), leaf, name)
        n += 1
    for i, layer in enumerate(tp["layers"]):
        for name, leaf in _flat(stack):
            node = layer
            for part in name.split("/"):
                node = node[part]
            assert node.dtype == torch.float32
            np.testing.assert_array_equal(node.numpy(), leaf[i], name)
            n += 1
    assert n == len(list(_flat(tp["layers"][0]))) * 2 + 2


def test_bridge_folded_leaves(ref, port):
    """Folded Wt arrives as bf16 (the reference's per-call rounding);
    bias and scales exactly."""
    tree_enc = ref[5]
    tpe = port[3]
    for i, layer in enumerate(tpe["layers"]):
        for sub, names in FAMS:
            for nm in names:
                src = tree_enc["stack"][sub]
                fw = layer[sub][nm + "_fw"]
                assert fw.dtype == torch.bfloat16
                ref_bf = jnp.asarray(src[nm + "_fw"][i]).astype(jnp.bfloat16)
                np.testing.assert_array_equal(
                    fw.float().numpy(), np.asarray(ref_bf, np.float32))
                for suf in ("_fb", "_as", "_ws"):
                    np.testing.assert_array_equal(
                        layer[sub][nm + suf].numpy(), src[nm + suf][i])


def test_init_model_matches_reference_structure(ref, port):
    """The port's own init gives the reference's leaf names and shapes."""
    tcfg, tp, _, _ = port
    own = t_init(tcfg, seed=0, device="cpu")

    def layout(tree):
        return sorted((k, tuple(v.shape), v.dtype) for k, v in _flat(tree))

    assert layout({k: v for k, v in own.items() if k != "layers"}) == \
        layout({k: v for k, v in tp.items() if k != "layers"})
    assert len(own["layers"]) == len(tp["layers"]) == tcfg.n_layers
    assert layout(own["layers"][1]) == layout(tp["layers"][1])


def test_entry_points_default_to_the_card(port):
    tcfg = port[0]
    if torch.cuda.is_available():
        assert t_init(tcfg).__class__ is dict
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_init(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_init_paged(tcfg, 4, 4)
    _, tp, _, _ = port
    with pytest.raises(RuntimeError, match="device='cpu'"):
        prepare_encoded_serving(tp, tcfg, macs_override=exact_encodings())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(tp, tcfg)


@pytest.mark.parametrize("mode", ["fp", "encoded"])
def test_full_forward_logits(ref, port, mode):
    jcfg, jp, tcfg, tp = _pairs(ref, port, mode)
    toks = np.random.default_rng(0).integers(0, 512, (2, 40)).astype(np.int32)
    jl, _, _ = j_apply(jp, jcfg, jnp.asarray(toks))
    with torch.inference_mode():
        tl, _ = t_apply(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("mode", ["fp", "encoded"])
@pytest.mark.parametrize("backend", ["gather", "kernel"])
def test_paged_prefill_decode_logits(ref, port, mode, backend):
    """Two rows prefilled one at a time into disjoint page chains, then
    ragged batched decode steps: every call's logits agree, through the
    gather path and through the fused gate."""
    jcfg, jp, tcfg, tp = _pairs(ref, port, mode)
    jcfg = dataclasses.replace(
        jcfg, attention_backend="xla" if backend == "gather" else "pallas")
    tcfg = dataclasses.replace(tcfg, attention_backend=backend)
    ps, n_pages = 4, 16
    pages = np.asarray([[3, 5, 1, 7, 9, 0], [2, 4, 6, 8, 10, 11]], np.int32)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (10, 17)]
    jl_ = j_init_paged(jcfg, n_pages, ps)["layers"]
    tl_ = t_init_paged(tcfg, n_pages, ps, device="cpu")["layers"]

    def both(tokens, pg, lens):
        nonlocal jl_
        jc = {"layers": jl_, "pages": jnp.asarray(pg),
              "lens": jnp.asarray(lens)}
        jlog, nc, _ = j_apply(jp, jcfg, jnp.asarray(tokens), cache=jc)
        jl_ = nc["layers"]
        tc = {"layers": tl_, "pages": torch.from_numpy(pg),
              "lens": torch.from_numpy(lens)}
        with torch.inference_mode():
            tlog, _ = t_apply(tp, tcfg, torch.from_numpy(tokens), cache=tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        return np.asarray(jlog)

    for b, pr in enumerate(prompts):
        both(pr[None], pages[b:b + 1], np.zeros(1, np.int32))
    lens = np.asarray([len(p) for p in prompts], np.int32)
    tok = np.asarray([[p[-1]] for p in prompts], np.int32)
    for _ in range(4):
        lg = both(tok, pages, lens)
        tok = np.argmax(lg[:, -1], -1).astype(np.int32)[:, None]
        lens = lens + 1
    # the pools were written in place to the reference's values
    for i in range(tcfg.n_layers):
        np.testing.assert_allclose(tl_[i]["pool_k"].numpy(),
                                   np.asarray(jl_["stack"]["pool_k"][i]),
                                   **TOL)


def test_own_calibration_matches_reference(ref, port):
    """The port's calibration stream gives the reference's per-layer
    activation scales."""
    tree_enc = ref[5]
    tcfg, tp, _, _ = port
    stats = capture_activation_stats(tp, tcfg)
    assert len(stats.amax) == 7 * tcfg.n_layers
    for sub, names in FAMS:
        for nm in names:
            want = tree_enc["stack"][sub][nm + "_as"]
            got = np.asarray([np.float32(stats.amax[(i, sub, nm)])
                              / np.float32(127) for i in range(2)])
            np.testing.assert_allclose(got, want, rtol=1e-6)


def test_own_fold_matches_reference(ref, port, tmp_path):
    tree_enc = ref[5]
    tcfg, tp, _, _ = port
    p_enc, c_enc, info = prepare_encoded_serving(
        tp, tcfg, macs_override=exact_encodings(), device="cpu",
        cache_dir=str(tmp_path), verbose=False)
    assert info["n_folded"] == 7 * tcfg.n_layers
    assert c_enc.mac.mode == "encoded_infer"
    for i, layer in enumerate(p_enc["layers"]):
        for sub, names in FAMS:
            src = tree_enc["stack"][sub]
            for nm in names:
                ref_bf = np.asarray(jnp.asarray(src[nm + "_fw"][i]).astype(
                    jnp.bfloat16), np.float32)
                np.testing.assert_array_equal(
                    layer[sub][nm + "_fw"].float().numpy(), ref_bf)
                np.testing.assert_array_equal(
                    layer[sub][nm + "_fb"].numpy(), src[nm + "_fb"][i])
                np.testing.assert_array_equal(
                    layer[sub][nm + "_ws"].numpy(), src[nm + "_ws"][i])
                np.testing.assert_allclose(
                    layer[sub][nm + "_as"].numpy(), src[nm + "_as"][i],
                    rtol=1e-6)
    # the fp params are shared, not copied, and left untouched
    assert p_enc["layers"][0]["attn"]["wq"] is tp["layers"][0]["attn"]["wq"]
    assert "wq_fw" not in tp["layers"][0]["attn"]


def test_search_encoding_is_not_ported(port, tmp_path):
    """The per-family search once refused here (no ``macs_override``); it
    is ported now: without an override every family is searched and
    folded with its own encoding (``tests/test_torch_encoded_bundle.py``
    holds the search against the reference)."""
    tcfg, tp, _, _ = port
    _, c_enc, info = prepare_encoded_serving(
        tp, tcfg, m_bits=16, n_samples=4, refine=0, calib_batches=1,
        cache_dir=str(tmp_path), verbose=False, device="cpu")
    assert not info["loaded"] and info["n_folded"] == 7 * tcfg.n_layers
    assert sorted(c_enc.mac.macs) == ["wg", "wi", "wk", "wo", "wq", "wv"]
    assert all(m.spec.m_bits == 16 and m.spec.rmse > 0
               for m in c_enc.mac.macs.values())
