"""Serving reduced deepseek-v3-671b (MLA, 4 heads, 8 experts) over a mesh
(gloo, the CPU): a 1x2 and a 2x1 mesh over two ranks, spawned once for
the module, and a 2x2 mesh over four, spawned once; each runs the static
engine (``ServeEngine(mesh=)``, ``mla_absorb`` off) and ``generate(mesh=)``
(``mla_absorb`` on), fp and exact-encoded from a bundle the reference
built.

At a model axis of 2 each rank runs 2 of the 4 MLA heads (its column
shards of ``wq_b``/``wk_b``/``wv_b``, raw and folded, and its row shard
of ``wo``) over the whole latent cache, and holds 4 of the 8 experts.
The tokens are token for token the JAX package's single-device
``ServeEngine``/``generate`` and the port's single rank.  At a data axis
of 2 each data row serves 2 of the 4 requests, whose MoE calls take the
capacity of their rows (the reference's ``t_local``): the reference's
serve they equal runs its MoE dispatch on the 2 data shards of each
call at that capacity (what its ``shard_map`` computes under a data
axis of 2), and the port's single rank serves each data row's requests
in turn (the four prompts are of one length, so a row of the split
carries no pads); the MoE layers drop as many pairs over the data rows
as that serve does.
Every rank holds the same tokens, and the cut leaves are the reference's
(``tests/test_torch_tp_vlm_encdec_serve.py`` holds the rules).  No rank
process imports JAX.
"""
import concurrent.futures
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "deepseek-v3-671b"
MESHES = ("1x2", "2x1", "2x2")
# (MAC mode, mla_absorb, entry point)
CASES = (("fp", False, "static"), ("encoded", False, "static"),
         ("fp", True, "generate"), ("encoded", True, "generate"))
N_REQ, PROMPT, MAX_NEW = 4, 16, 6


def _key(case):
    mode, absorb, entry = case
    return f"{mode}-{'absorb' if absorb else 'naive'}-{entry}"


def _prompts():
    rng = np.random.default_rng(0)
    return rng.integers(0, 512, (N_REQ, PROMPT)).astype(np.int32)


def _tcfg():
    from repro_torch.configs import get_config
    return get_config(ARCH).reduced()


def _serve(params, cfg, case, mesh=None, rows=N_REQ):
    """One serve's tokens and its MoE calls' dropped pairs.  Without a
    mesh, ``rows``: the requests a call holds (all of them, or a data
    row's: the requests in turns of that many)."""
    import repro_torch.nn.moe as TMOE
    from repro_torch.serve import ServeEngine, generate
    _, absorb, entry = case
    cfg = dataclasses.replace(cfg, mla_absorb=absorb)
    drops, plan = [], TMOE.dispatch_plan

    def counted(idx, n_experts, cap):
        out = plan(idx, n_experts, cap)
        drops.append(int((~out[2]).sum()))
        return out
    TMOE.dispatch_plan = counted
    try:
        prompts = _prompts()
        if entry == "static":
            eng = ServeEngine(params, cfg, batch_slots=rows if mesh is None
                              else N_REQ, device="cpu", mesh=mesh)
            toks = [o.tolist() for o in eng.run(list(prompts),
                                                 max_new=MAX_NEW)]
        else:
            toks = sum((generate(params, cfg, prompts[i:i + rows], MAX_NEW,
                                 mesh=mesh).tolist()
                        for i in range(0, N_REQ, rows)), [])
    finally:
        TMOE.dispatch_plan = plan
    return toks, drops


def _encoded(params, cfg, bundle):
    from repro_torch.serve import (arch_families, exact_encodings,
                                   prepare_encoded_serving)
    pe, ce, info = prepare_encoded_serving(
        params, cfg, macs_override=exact_encodings(
            families=arch_families(cfg)), cache_dir=bundle, device="cpu",
        verbose=False)
    assert info["loaded"]
    return pe, ce


def _rank(mesh, params, bundle, built):
    """Every case on this rank, at the spawned mesh and (two ranks) at a
    2x1 mesh of the same ranks: tokens, every rank's dropped pairs, the
    ranks' agreement, a rank's MLA leaves' shapes.  The fp cases run
    while the parent builds the reference's bundle; the encoded ones once
    the file ``built`` exists."""
    import os
    import time
    import torch.distributed as dist
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.sharding import shard_params
    cfg = _tcfg()
    meshes = {f"{mesh.n_data}x{mesh.n_model}": mesh}
    if dist.get_world_size() == 2:
        meshes["2x1"] = Mesh(2, 1)
    trees = {"fp": (params, cfg)}
    out = {}
    for mode in ("fp", "encoded"):
        if mode == "encoded":
            while not os.path.exists(built):
                time.sleep(0.2)
            trees[mode] = _encoded(params, cfg, bundle)
        for tag, m in meshes.items():
            for case in CASES:
                if case[0] != mode:
                    continue
                toks, drops = _serve(*trees[mode], case, m)
                got = [None] * dist.get_world_size()
                dist.all_gather_object(got, (m.data_rank, m.model_rank,
                                             drops))
                out[(tag, _key(case))] = {"tokens": toks, "drops": got,
                                          "agree": m.agree(toks)}
    for tag, m in meshes.items():
        mla = shard_params(trees["encoded"][0], cfg, m)["layers"][0]["mla"]
        out[(tag, "mla")] = {k: tuple(v.shape) for k, v in mla.items()}
    return out


_LOCAL = threading.local()


def _sharded_dispatch(jcfg, orig):
    """The reference's ``dispatch_compute`` run on this thread's
    ``_LOCAL.n_data`` data shards of a call's token rows (1 if unset),
    each at the capacity of its rows: the computation of its ``shard_map``
    under a data axis of that size (``src/repro/nn/moe.py:136-154``)."""
    import jax.numpy as jnp

    def dispatch(x2, idx, w, wi, wg, wo, *, n_experts_total, capacity, act,
                 axis_name):
        n = getattr(_LOCAL, "n_data", 1)
        t = x2.shape[0] // n
        if n > 1:
            capacity = max(4, int(jcfg.capacity_factor * t * jcfg.top_k
                                  / jcfg.n_experts))
        return jnp.concatenate([orig(
            x2[i:i + t], idx[i:i + t], w[i:i + t], wi, wg, wo,
            n_experts_total=n_experts_total, capacity=capacity, act=act,
            axis_name=axis_name) for i in range(0, x2.shape[0], t)], 0)
    return dispatch


def _reference(jp, jcfg, case, n_data):
    """The reference's single-device tokens of ``case``, its MoE dispatch
    on ``n_data`` shards of each call (``_sharded_dispatch``)."""
    from repro.serve.engine import ServeEngine as JServe
    from repro.serve.engine import generate as jgen
    _, absorb, entry = case
    c = dataclasses.replace(jcfg, mla_absorb=absorb)
    _LOCAL.n_data = n_data
    try:
        if entry == "static":
            return [np.asarray(o).tolist() for o in JServe(
                jp, c, batch_slots=N_REQ).run(list(_prompts()),
                                              max_new=MAX_NEW)]
        return np.asarray(jgen(jp, c, _prompts(), MAX_NEW)).tolist()
    finally:
        _LOCAL.n_data = 1


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's single-device tokens (every request at once, and
    a data row's requests at a time), the port's single rank's (and its
    drops), the ranks' results by mesh."""
    import jax
    from repro.configs import get_config as jget
    from repro.core.circuits import exact_product_circuit
    from repro.core.encoding import EncodingSpec
    from repro.core.mac import EncodedMac
    from repro.models import init_model as j_init
    from repro.serve.encoded import prepare_encoded_serving as j_prepare
    from repro_torch.models import params_from_jax
    from repro_torch.parallel.mesh import run_ranks
    from repro_torch.serve import arch_families
    from repro.nn import moe as jm
    jcfg = jget(ARCH).reduced()
    # jitted: a fraction of the eager init's compile time
    jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    orig = jm.dispatch_compute
    jm.dispatch_compute = _sharded_dispatch(jcfg, orig)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             _tcfg(), "cpu")
    bundle = str(tmp_path_factory.mktemp("ref_bundle"))
    built = str(tmp_path_factory.mktemp("flags") / "bundle-built")
    def references(p, c, case):
        return {(_key(case), N_REQ // n_data): _reference(p, c, case, n_data)
                for n_data in (1, 2)}
    # the ranks and the reference's fp serves run while the reference
    # builds its bundle here; then its encoded serves, a thread a case
    try:
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            two = ex.submit(run_ranks, _rank, 2, params, bundle, built)
            four = ex.submit(run_ranks, _rank, 2, params, bundle, built,
                             n_data=2)
            fp = ex.submit(lambda: [references(jp, jcfg, case)
                                    for case in CASES if case[0] == "fp"])
            circ, s = exact_product_circuit(8, 8)
            mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
            jpe, jce, _ = j_prepare(jp, jcfg, macs_override={
                n: mac for n in arch_families(_tcfg())}, cache_dir=bundle,
                verbose=False)
            open(built, "w").close()
            enc = [ex.submit(references, jpe, jce, case) for case in CASES
                   if case[0] == "encoded"]
            want = {}
            for got in fp.result() + [f.result() for f in enc]:
                want.update(got)
            ranks = two.result()
            ranks.update(four.result())
    finally:
        jm.dispatch_compute = orig
    trees = {"fp": (params, _tcfg()),
             "encoded": _encoded(params, _tcfg(), bundle)}
    single = {(_key(case), rows): _serve(*trees[case[0]], case, rows=rows)
              for case in CASES for rows in (N_REQ, N_REQ // 2)}
    return want, single, ranks


def _rows(mesh):
    """The requests a call of ``mesh`` holds."""
    return N_REQ // int(mesh.split("x")[0])


@pytest.mark.parametrize("case", CASES, ids=_key)
@pytest.mark.parametrize("mesh", MESHES)
def test_mla_tokens_match_reference_and_single_rank(runs, mesh, case):
    want, single, ranks = runs
    ref = want[(_key(case), _rows(mesh))]
    assert single[(_key(case), _rows(mesh))][0] == ref
    assert ranks[(mesh, _key(case))]["tokens"] == ref


@pytest.mark.parametrize("case", CASES, ids=_key)
@pytest.mark.parametrize("mesh", MESHES)
def test_mla_drops_equal_single_rank_and_ranks_agree(runs, mesh, case):
    """Every rank holds the same tokens; the MoE calls of each data row
    (read on its first model rank) drop as many pairs in all as the
    single rank's serve of each data row's requests, call for call where
    no data axis splits them (every rank plans the whole routing)."""
    _, single, ranks = runs
    r = ranks[(mesh, _key(case))]
    assert r["agree"]
    want = single[(_key(case), _rows(mesh))][1]
    rows = [d for _, m, d in sorted(r["drops"]) if m == 0]
    if len(rows) == 1:
        assert rows[0] == want
    assert sum(map(sum, rows)) == sum(want)


def test_mla_cases_drop_pairs(runs):
    """Some of the single rank's serves drop pairs, so the drop checks
    compare counts that are not all zero."""
    assert any(sum(drops) > 0 for _, drops in runs[1].values())


@pytest.mark.parametrize("mesh", MESHES)
def test_mla_rank_holds_half_the_heads_whole_latent(runs, mesh):
    """A rank's MLA leaves at a model axis of 2: ``wq_b``/``wk_b``/
    ``wv_b`` and their folds hold 2 of the 4 heads' columns, ``wo`` and
    its fold 2 heads' rows; the low-rank down projections whole (at a
    model axis of 1, every leaf whole)."""
    from repro_torch.configs import get_config
    cfg = get_config(ARCH).reduced()
    got = runs[2][(mesh, "mla")]
    tp = int(mesh.split("x")[1])
    H = cfg.n_heads_p // tp
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    assert got["wq_b"] == (cfg.q_lora_rank, H * (dn + dr))
    assert got["wk_b"] == (cfg.kv_lora_rank, H * dn)
    assert got["wv_b"] == (cfg.kv_lora_rank, H * dv)
    assert got["wk_b_fw"][1:] == (cfg.kv_lora_rank, H * dn)
    assert got["wo"] == (H * dv, cfg.d_model)
    assert got["wo_fw"][1:] == (H * dv, cfg.d_model)
    assert got["wq_a"] == (cfg.d_model, cfg.q_lora_rank)
    assert got["wkv_a"] == (cfg.d_model, cfg.kv_lora_rank)
    assert got["wkr"] == (cfg.d_model, dr)
