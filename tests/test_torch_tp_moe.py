"""Expert parallelism of reduced qwen3-moe-235b-a22b on 2 ranks (gloo, the
CPU): each rank holds 4 of the 8 experts and its slices of the attention
and the untied head.  The continuous engine (fp and exact-encoded, f32
pools, the plain paged-attention kernel path) and the static engine give
the JAX package's single-device tokens and the port's single rank's, and
every MoE call drops the pairs the single rank's call drops (capacity from
the tokens of a data shard, the whole batch at data = 1).

The ranks are spawned once for the module and run every serve; no rank
process imports JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

ARCH = "qwen3-moe-235b-a22b"
TP = 2
CASES = ("cont_fp", "cont_encoded", "static_fp")
KW = dict(n_slots=3, page_size=8, n_pages=64, prefill_chunk=16)


def _trace():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (40, 13, 35, 7, 50)]


def _tcfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH).reduced(),
                               attention_backend="kernel")


def _serve(params, name, mesh=None, bundle=None):
    """(tokens, MoE drops per call, mesh stats) of one case."""
    import repro_torch.nn.moe as TMOE
    from repro_torch.serve import (Engine, ServeEngine, exact_encodings,
                                   prepare_encoded_serving)
    cfg = _tcfg()
    if name.endswith("encoded"):
        params, cfg, _ = prepare_encoded_serving(
            params, cfg, macs_override=exact_encodings(), cache_dir=bundle,
            device="cpu", verbose=False)
    drops, plan = [], TMOE.dispatch_plan

    def counted(idx, n_experts, cap):
        out = plan(idx, n_experts, cap)
        drops.append(int((~out[2]).sum()))
        return out
    TMOE.dispatch_plan = counted
    try:
        if name.startswith("static"):
            eng = ServeEngine(params, cfg, batch_slots=2, device="cpu",
                              mesh=mesh)
            toks = [o.tolist() for o in eng.run(_trace(), max_new=8)]
        else:
            eng = Engine(params, cfg, device="cpu", mesh=mesh, **KW)
            rids = [eng.submit(p, max_new=8) for p in _trace()]
            outs = eng.run()
            toks = [outs[r].tolist() for r in rids]
    finally:
        TMOE.dispatch_plan = plan
    st = eng.stats()
    return toks, drops, (st["mesh"], st["mesh_replicated"]), eng


def _rank(mesh, params, bundle):
    out = {}
    for name in CASES:
        toks, drops, ms, eng = _serve(params, name, mesh, bundle)
        layer = eng.params["layers"][0]["moe"]
        out[name] = {"tokens": toks, "drops": drops, "mesh": ms,
                     "agree": mesh.agree((toks, drops)),
                     "experts": layer["experts_wi"].shape[0]}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.configs import get_config as jget
    from repro.core.circuits import exact_product_circuit
    from repro.core.encoding import EncodingSpec
    from repro.core.mac import EncodedMac
    from repro.models import init_model as j_init
    from repro.serve import Engine as JEngine
    from repro.serve.encoded import prepare_encoded_serving as j_prepare
    from repro.serve.engine import ServeEngine as JServe
    from repro_torch.models import params_from_jax
    from repro_torch.parallel.mesh import run_ranks
    from repro_torch.serve import arch_families
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    jcfg = jget(ARCH).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    circ, s = exact_product_circuit(8, 8)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    bundle = str(tmp_path_factory.mktemp("ref_bundle"))
    jpe, jce, _ = j_prepare(jp, jcfg, macs_override={
        n: mac for n in arch_families(_tcfg())}, cache_dir=bundle,
        verbose=False)
    want = {}
    for name, (p, c) in (("cont_fp", (jp, jcfg)),
                         ("cont_encoded", (jpe, jce))):
        eng = JEngine(p, dataclasses.replace(c, attention_backend="pallas"),
                      **KW)
        rids = [eng.submit(q, max_new=8) for q in _trace()]
        res = eng.run()
        want[name] = [np.asarray(res[r]).tolist() for r in rids]
    want["static_fp"] = [np.asarray(o).tolist() for o in JServe(
        jp, jcfg, batch_slots=2).run(_trace(), max_new=8)]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             _tcfg(), "cpu")
    single = {name: _serve(params, name, bundle=bundle)[:2]
              for name in CASES}
    ranks = run_ranks(_rank, TP, params, bundle)
    torch.set_num_threads(n_threads)
    return want, single, ranks


@pytest.mark.parametrize("name", CASES)
def test_ep_tokens_match_reference_and_single_rank(runs, name):
    want, single, ranks = runs
    assert single[name][0] == want[name]
    assert ranks[name]["tokens"] == want[name]


@pytest.mark.parametrize("name", CASES)
def test_ep_drops_per_call_equal_single_rank(runs, name):
    """Every MoE call drops what the single rank's call drops (> 0 in
    all: a short prompt's padded chunk overflows its experts)."""
    _, single, ranks = runs
    assert ranks[name]["drops"] == single[name][1]
    assert sum(single[name][1]) > 0


@pytest.mark.parametrize("name", CASES)
def test_ep_ranks_agree_and_hold_half_the_experts(runs, name):
    r = runs[2][name]
    assert r["agree"]
    assert r["experts"] == 8 // TP
    assert r["mesh"] == ({"data": 1, "model": TP}, [])
