"""Tensor parallelism at 4 ranks (gloo, the CPU): kernel 1's column and
row dispatch (``nn.common.linear`` under a mesh: a rank's n-slice, or its
k-slice with a zero bias, the partials summed and the bias added once)
against the reference's unsharded encoded matmul (its
``sharded_kernel_roles_match``), with the int8 executor's weight scale
taken over every shard; and the divisibility fallback: reduced
qwen1.5-0.5b's 2 kv heads do not divide 4 ranks, so its attention runs
replicated while its MLP and head shard, and the continuous engine still
gives the JAX package's single-device tokens.

The ranks are spawned once for the module; no rank process imports JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TP = 4
M, K, N = 5, 64, 48
KW = dict(n_slots=3, page_size=8, n_pages=64, prefill_chunk=16)


def _trace():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (40, 13, 35, 7, 50)]


def _linear_case():
    """x (M, K) f32 and one encoded linear's whole leaves per role: the
    exact encoding's fold of random int8 weights (exact-fold
    magnitudes), a non-zero bias, activation and weight scales."""
    from repro_torch.serve import exact_encodings
    mac = exact_encodings()["wq"]
    g = torch.Generator().manual_seed(0)
    x = torch.randn((M, K), generator=g) * 3
    wc = torch.randint(-127, 128, (K, N), generator=g).to(torch.int8)
    s = torch.as_tensor(np.asarray(mac.spec.s, np.float32))
    wt, b = mac.program.fold_weights(wc, s)
    return x, {"w_fw": wt.to(torch.bfloat16), "w_fb": b + 0.25,
               "w_as": torch.tensor(0.05), "w_ws": torch.tensor(0.01),
               "w": wc.float()}


def _mcfg(mode):
    from repro_torch.core.layers import MacConfig
    from repro_torch.serve import exact_encodings
    if mode == "encoded":
        return MacConfig(mode="encoded_infer", macs=exact_encodings())
    return MacConfig(mode="int8")


def _cut(leaves, r, name):
    """Rank ``r``'s leaves of linear ``name`` (its role by name, as
    ``parallel.sharding`` cuts a block's linears)."""
    from repro_torch.parallel.sharding import _shard_linears
    node = {name + k[1:]: v for k, v in leaves.items()}
    return _shard_linears(node, TP, r)


def _rank(mesh, qwen_params):
    from repro_torch.nn.common import linear
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.serve import Engine
    from repro_torch.configs import get_config
    x, leaves = _linear_case()
    r = mesh.model_rank
    out = {}
    for mode in ("encoded", "int8"):
        mcfg = _mcfg(mode)
        # column: wq's n-slice, the whole x; gathered to (M, N)
        col = _cut(leaves, r, "wq")
        with set_mesh(mesh):
            yc = mesh.gather_columns(linear(col, "wq", x, mcfg, ways=TP))
        # row: wo's k-slice and x's, zero-bias partials summed
        row = _cut(leaves, r, "wo")
        xs = x[:, r * K // TP:(r + 1) * K // TP]
        with set_mesh(mesh):
            yr = linear(row, "wo", xs, mcfg, ways=TP)
        out[mode] = (yc.numpy(), yr.numpy(), col["wq_fw"].shape,
                     row["wo_fw"].shape, row["wo_fb"].shape)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              attention_backend="kernel")
    eng = Engine(qwen_params, cfg, device="cpu", mesh=mesh, **KW)
    rids = [eng.submit(p, max_new=8) for p in _trace()]
    res = eng.run()
    toks = [res[i].tolist() for i in rids]
    st = eng.stats()
    layer = eng.params["layers"][0]
    out["qwen"] = {"tokens": toks, "agree": mesh.agree(toks),
                   "replicated": st["mesh_replicated"],
                   "pool_heads": eng.kv.layers[0]["pool_k"].shape[2],
                   "wq": tuple(layer["attn"]["wq"].shape),
                   "wi": tuple(layer["mlp"]["wi"].shape),
                   "wo": tuple(layer["mlp"]["wo"].shape)}
    return out


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.kernels.ops import encoded_matmul as j_em
    from repro.models import init_model as j_init
    from repro.serve import Engine as JEngine
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_jax
    from repro_torch.parallel.mesh import run_ranks
    from repro_torch.quant.uniform import (calibrate_scale, fake_quant,
                                           quantize_codes)
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    x, leaves = _linear_case()
    monos = _mcfg("encoded").mac_for("wq").program.a_mono_tuples
    codes = quantize_codes(x, leaves["w_as"], 8)
    y = j_em(jnp.asarray(codes.numpy()),
             jnp.asarray(leaves["w_fw"].float().numpy()),
             jnp.asarray(leaves["w_fb"].numpy()), monos,
             backend="pallas_interpret")
    ref = {"encoded": np.asarray(y) * np.float32(leaves["w_as"]
                                                 * leaves["w_ws"])}
    w = leaves["w"]
    ref["int8"] = (fake_quant(x, leaves["w_as"], 8)
                   @ fake_quant(w, calibrate_scale(w, 8), 8)).numpy()
    jcfg = jget("qwen1.5-0.5b").reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    je = JEngine(jp, dataclasses.replace(jcfg, attention_backend="pallas"),
                 **KW)
    rids = [je.submit(p, max_new=8) for p in _trace()]
    res = je.run()
    want = [np.asarray(res[r]).tolist() for r in rids]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             get_config("qwen1.5-0.5b").reduced(), "cpu")
    ranks = run_ranks(_rank, TP, params)
    torch.set_num_threads(n_threads)
    return ref, want, ranks


@pytest.mark.parametrize("mode", ["encoded", "int8"])
def test_column_and_row_dispatch_match_the_unsharded_call(runs, mode):
    """Both roles give the reference's unsharded product: bit for bit
    with the exact encoding (integer partial sums), within f32 order for
    the int8 executor, whose weight scale is the max over every shard."""
    ref, _, ranks = runs
    yc, yr, col_shape, row_shape, fb_shape = ranks[mode]
    # int8: f32 sums of K products in another order, a few ulps of the
    # largest output
    tol = dict(rtol=0, atol=0) if mode == "encoded" else \
        dict(rtol=0, atol=1e-5 * np.abs(ref[mode]).max())
    np.testing.assert_allclose(yc, ref[mode], **tol)
    np.testing.assert_allclose(yr, ref[mode], **tol)
    if mode == "encoded":
        U = col_shape[0]
        assert col_shape == (U, K, N // TP)
        assert row_shape == (U, K // TP, N) and fb_shape == (N,)


def test_fallback_replicates_what_does_not_divide(runs):
    """At 4 ranks the 2 kv heads run replicated (whole wq and pools),
    the MLP and the head shard, and the tokens are the reference's."""
    _, want, ranks = runs
    q = ranks["qwen"]
    assert q["agree"]
    assert q["replicated"] == ["attn"]
    assert q["pool_heads"] == 2
    assert q["wq"] == (128, 4 * 32)
    assert q["wi"] == (128, 256 // TP) and q["wo"] == (256 // TP, 128)
    assert q["tokens"] == want
