"""Tensor-parallel serving of reduced qwen1.5-0.5b on 2 ranks (gloo, the
CPU): the continuous engine through the plain paged-attention kernel path
with f32, int8 and int4 pools, the prefix cache, spec decoding at k = 4,
``--mac int8`` and exact-encoded serving from a bundle the reference
built, and the static engine; each token for token the JAX package's
single-device engine and the port's single rank.

The ranks are spawned once for the module (``parallel.mesh.run_ranks``)
and run every serve; rank 0 returns what the tests assert: the tokens,
whether every rank held the same tokens, stats and allocator state, the
mesh stats, the prefix hits and the folded bytes a rank keeps.  The rank
processes import no JAX: it is imported only in the fixture that runs
the reference.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "qwen1.5-0.5b"
TP = 2
CONT = ("f32", "int8", "int4", "prefix", "spec", "mac_int8", "encoded")
KW = dict(n_slots=3, page_size=8, n_pages=64, prefill_chunk=16)


def _trace():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (40, 13, 35, 7, 50)]


def _prefix_trace():
    """Prompts 0, 2 and 4 share a 24-token prefix (3 pages)."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 512, 24).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, 512, n).astype(np.int32)])
            if i % 2 == 0 else rng.integers(0, 512, n).astype(np.int32)
            for i, n in enumerate((9, 30, 5, 17, 12))]


def _case(name):
    """(kv dtype, engine kwargs, trace) of a continuous case."""
    kv = name if name in ("int8", "int4") else "bf16"
    eng = {"prefix": dict(prefix_cache=True),
           "spec": dict(spec_decode=4)}.get(name, {})
    return kv, eng, _prefix_trace() if name == "prefix" else _trace()


def _tcfg(name):
    from repro_torch.configs import get_config
    from repro_torch.core.layers import MacConfig
    kv, _, _ = _case(name)
    cfg = dataclasses.replace(get_config(ARCH).reduced(), kv_cache_dtype=kv,
                              attention_backend="kernel")
    if name == "mac_int8":
        cfg = dataclasses.replace(cfg, mac=MacConfig(mode="int8"))
    return cfg


def _fw_bytes(tree) -> int:
    """Bytes of every folded ``*_fw`` leaf of a param tree."""
    if isinstance(tree, list):
        return sum(map(_fw_bytes, tree))
    if not isinstance(tree, dict):
        return 0
    return sum(v.numel() * v.element_size() if k.endswith("_fw")
               else _fw_bytes(v) for k, v in tree.items())


def _serve(params, name, mesh=None, bundle=None):
    """One serve of a case: (tokens, engine, the bundle's info or None).
    ``params``: {"fp": …, "int8": …} (the int8 executor's params carry
    its activation scales); ``encoded`` loads the exact bundle from
    ``bundle``."""
    from repro_torch.serve import (Engine, ServeEngine, exact_encodings,
                                   prepare_encoded_serving)
    cfg, info = _tcfg(name if name != "static" else "f32"), None
    params = params["int8" if name == "mac_int8" else "fp"]
    if name == "encoded":
        params, cfg, info = prepare_encoded_serving(
            params, cfg, macs_override=exact_encodings(), cache_dir=bundle,
            device="cpu", verbose=False)
    if name == "static":
        eng = ServeEngine(params, cfg, batch_slots=2, device="cpu",
                          mesh=mesh)
        return [o.tolist() for o in eng.run(_trace(), max_new=8)], eng, info
    _, kw, trace = _case(name)
    eng = Engine(params, cfg, device="cpu", mesh=mesh, **KW, **kw)
    rids = [eng.submit(p, max_new=8) for p in trace]
    outs = eng.run()
    return [outs[r].tolist() for r in rids], eng, info


_CLOCKS = ("_ms", "_s_", "latency", "ttft", "tpot")


def _rank(mesh, params, bundle):
    """Every case on this rank: tokens, the ranks' agreement, stats."""
    out = {}
    for name in CONT + ("static",):
        toks, eng, info = _serve(params, name, mesh, bundle)
        st = eng.stats()
        det = {k: v for k, v in st.items()
               if not any(c in k for c in _CLOCKS) and not k.endswith("_s")}
        state = (det,) if name == "static" else (
            det, eng.kv.alloc.state(), eng.kv.ptab.tolist(),
            eng.kv.lens.tolist())
        out[name] = {"tokens": toks, "agree": mesh.agree((toks, state)),
                     "mesh": st["mesh"], "replicated": st["mesh_replicated"],
                     "hits": st.get("prefix_hit_tokens", 0)}
        if info is not None:
            out[name].update(loaded=info["loaded"],
                             fw_local=_fw_bytes(eng.params))
    out["collectives"] = mesh.collectives
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's single-device tokens, the port's single rank's,
    and the 2 ranks' results."""
    import jax
    from repro.configs import get_config as jget
    from repro.core.circuits import exact_product_circuit
    from repro.core.encoding import EncodingSpec
    from repro.core.layers import MacConfig as JMac
    from repro.core.mac import EncodedMac
    from repro.models import init_model as j_init
    from repro.serve import Engine as JEngine
    from repro.serve.encoded import prepare_encoded_serving as j_prepare
    from repro.serve.engine import ServeEngine as JServe
    from repro_torch.models import params_from_jax
    from repro_torch.parallel.mesh import run_ranks
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jget(ARCH).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    bundle = str(tmp_path_factory.mktemp("ref_bundle"))
    jpe, jce, _ = j_prepare(jp, jcfg, macs_override={
        n: mac for n in ("wq", "wk", "wv", "wo", "wi", "wg", "w")},
        cache_dir=bundle, verbose=False)
    jcfg8 = dataclasses.replace(jcfg, mac=JMac(mode="int8"))
    jp8 = j_init(jax.random.PRNGKey(0), jcfg8)
    want = {}
    for name in CONT:
        kv, kw, trace = _case(name)
        p, c = {"encoded": (jpe, jce), "mac_int8": (jp8, jcfg8)}.get(
            name, (jp, jcfg))
        c = dataclasses.replace(c, kv_cache_dtype=kv,
                                attention_backend="pallas")
        eng = JEngine(p, c, **KW, **kw)
        rids = [eng.submit(q, max_new=8) for q in trace]
        res = eng.run()
        want[name] = [np.asarray(res[r]).tolist() for r in rids]
    want["static"] = [np.asarray(o).tolist() for o in
                      JServe(jp, jcfg, batch_slots=2).run(_trace(),
                                                          max_new=8)]
    params = {m: params_from_jax(jax.tree_util.tree_map(np.asarray, t),
                                 _tcfg(name), "cpu")
              for m, t, name in (("fp", jp, "f32"), ("int8", jp8,
                                                     "mac_int8"))}
    single, fw_whole = {}, None
    for name in CONT + ("static",):
        single[name], eng, info = _serve(params, name, bundle=bundle)
        if info is not None:
            fw_whole = _fw_bytes(eng.params)
    ranks = run_ranks(_rank, TP, params, bundle)
    ranks["encoded"]["fw_whole"] = fw_whole
    torch.set_num_threads(n_threads)
    return want, single, ranks


@pytest.mark.parametrize("name", CONT + ("static",))
def test_tp_tokens_match_reference_and_single_rank(runs, name):
    want, single, ranks = runs
    assert single[name] == want[name]
    assert ranks[name]["tokens"] == want[name]


@pytest.mark.parametrize("name", CONT + ("static",))
def test_ranks_agree_and_report_the_mesh(runs, name):
    """Every rank holds the same tokens, stats (and, continuous, the
    allocator's state, page tables and lens); nothing runs replicated at
    2 ranks (2 kv heads, d_ff 256, vocab 512)."""
    r = runs[2][name]
    assert r["agree"]
    assert r["mesh"] == {"data": 1, "model": TP}
    assert r["replicated"] == []


def test_prefix_cache_hits_under_the_mesh(runs):
    assert runs[2]["prefix"]["hits"] > 0


def test_reference_bundle_is_a_cache_hit_and_halved(runs):
    """The reference's bundle loads under the mesh, and a rank keeps half
    of every folded tensor: column and row linears split evenly."""
    r = runs[2]["encoded"]
    assert r["loaded"]
    assert r["fw_local"] * TP == r["fw_whole"] > 0


def test_collectives_ran(runs):
    assert runs[2]["collectives"] > 0
