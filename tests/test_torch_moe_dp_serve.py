"""MoE over a data axis (gloo, the CPU), by the reference's capacity
rules (``repro/nn/moe.py:130-160``).

* Reduced qwen3-moe-235b-a22b (8 experts, top 2) at 2x1 (the reference's
  ``ep`` holds at a model axis of 1) and 2x2 (EP): the MoE layer's
  outputs and dropped pairs equal the reference's ``dispatch_compute``
  run on each data shard at the ``t_local`` capacity, for a call that
  holds a data row's rows (a split decode step) and for one that holds
  the whole batch on every row (a replicated B = 1 prefill chunk, cut
  into D shards); a replicated call whose rows D does not divide is
  refused, as the reference's ``shard_map``.  The continuous engine's
  tokens equal the reference's single-device engine with its MoE layer
  run on D data shards at ``t_local`` (the computation of the
  reference's ``shard_map`` on each shard).
* The same config with 3 experts at 2x2 (they do not divide the model
  axis: no EP): one global dispatch at the whole batch's capacity.  The
  layer's outputs and drops equal the reference's global
  ``dispatch_compute``; the engine's tokens equal the reference's
  single-device engine; one train step's loss, params and Adafactor
  moments equal the reference's single-device step within the tolerances
  of ``tests/test_torch_moe_dp_train.py``.

Each mesh is spawned once for the module; no rank process imports JAX.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import torch_mesh_train as H  # noqa: E402

ARCH = H.MOE_ARCH
D = 2
MESHES = ((2, 1), (2, 2))
NON_EP = dict(n_experts=3, top_k=2)
KW = dict(n_slots=4, page_size=8, n_pages=64, prefill_chunk=16)
MAX_NEW = 6
LAYER_B, LAYER_S = 4, 4          # a split call: 2 rows a data row
CHUNK = 16                       # a replicated prefill chunk (1, 16)
MOE_TOL = dict(rtol=5e-3, atol=5e-3)


def _trace():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32)
            for n in (40, 13, 35, 7, 50)]


def _layer_params(p_np, E, n_model, model_rank):
    """A rank's MoE layer params: its experts where they split (EP)."""
    p = {"router": {"w": torch.from_numpy(p_np["router"]["w"])}}
    n = E // n_model if E % n_model == 0 else E
    lo = model_rank * n if n != E else 0
    for k in ("experts_wi", "experts_wg", "experts_wo"):
        p[k] = torch.from_numpy(p_np[k][lo:lo + n])
    return p


def _layers(mesh, cfg, p_np, x_split, x_rep):
    """The MoE layer on a split call (this data row's rows) and on a
    replicated one (every row): (output, the (T, capacity, drops) of
    each dispatch) of each; and the refusal of a replicated call of 3
    rows."""
    from repro_torch.nn import moe as M
    from repro_torch.parallel.mesh import replicated_batch, set_mesh
    p = _layer_params(p_np, cfg.n_experts, mesh.n_model, mesh.model_rank)
    plans = []
    plan = M.dispatch_plan

    def recorded(idx, n_experts, cap):
        got = plan(idx, n_experts, cap)
        plans.append((int(idx.shape[0]), cap, int((~got[2]).sum())))
        return got
    M.dispatch_plan = recorded
    out = {}
    try:
        rows = x_split.shape[0] // mesh.n_data
        for name, x, rep in (
                ("split", x_split[mesh.data_rank * rows:
                                  (mesh.data_rank + 1) * rows], False),
                ("replicated", x_rep, True)):
            plans.clear()
            with torch.no_grad(), set_mesh(mesh), replicated_batch(rep):
                y, _ = M.moe_apply(p, torch.from_numpy(x), cfg)
            out[name] = (y.numpy(), list(plans))
        try:
            with torch.no_grad(), set_mesh(mesh), replicated_batch(True):
                M.moe_apply(p, torch.from_numpy(x_rep[:, :3]), cfg)
            out["refusal"] = None
        except ValueError as e:
            out["refusal"] = str(e)
    finally:
        M.dispatch_plan = plan
    return out


def _serve(mesh, params_np, cfg):
    from repro_torch.models import params_from_jax
    from repro_torch.serve import Engine
    eng = Engine(params_from_jax(params_np, cfg, "cpu"), cfg, device="cpu",
                 mesh=mesh, **KW)
    rids = [eng.submit(p, max_new=MAX_NEW) for p in _trace()]
    outs = eng.run()
    toks = [outs[r].tolist() for r in rids]
    st = eng.stats()
    return {"tokens": toks, "split": st["data_split"],
            "agree": mesh.agree((toks, eng.kv.alloc.state()))}


def _rank(mesh, models, layer_x, train_jobs):
    """Every check of this mesh: per model (its name → (cfg, params,
    MoE layer params)) the layer on every rank and the serve; the train
    jobs."""
    import torch.distributed as dist
    out = {}
    for name, (cfg, params_np, p_np) in models.items():
        mine = (mesh.data_rank, mesh.model_rank,
                _layers(mesh, cfg, p_np, *layer_x))
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine)
        out[name] = {"layers": got, "serve": _serve(mesh, params_np, cfg)}
    if train_jobs:
        out["train"] = H.train_jobs(mesh, train_jobs)
    return out


# --- the parent: the reference ----------------------------------------------

def _np_layer(jparams):
    m = jparams["moe_stack"]["moe"]
    return {"router": {"w": np.asarray(m["router"]["w"][0])},
            **{k: np.asarray(m[k][0]) for k in ("experts_wi", "experts_wg",
                                                "experts_wo")}}


def _shards_moe_apply(n_shards):
    """The reference's MoE layer with its dispatch run on ``n_shards``
    data shards of the call's token rows at the capacity of one shard:
    what its ``shard_map`` computes on each shard of a data axis."""
    import jax.numpy as jnp
    from repro.nn import moe as jm

    def moe_apply(p, x, cfg):
        B, S, d = x.shape
        x2 = x.reshape(B * S, d)
        idx, w, aux = jm.route(p, x2, cfg)
        t = B * S // n_shards
        cap = max(4, int(cfg.capacity_factor * t * cfg.top_k
                         / cfg.n_experts))
        out = jnp.concatenate([jm.dispatch_compute(
            x2[i:i + t], idx[i:i + t], w[i:i + t], p["experts_wi"],
            p["experts_wg"], p["experts_wo"], n_experts_total=cfg.n_experts,
            capacity=cap, act=cfg.act, axis_name=None)
            for i in range(0, B * S, t)], 0)
        return out.astype(cfg.cdtype).reshape(B, S, d), aux
    return moe_apply


def _ref_serve(jp, jcfg, moe_apply=None):
    """The reference's single-device engine's tokens; with ``moe_apply``
    in place of its MoE layer (its step caches cleared around)."""
    from repro.nn import blocks
    from repro.serve import Engine as JEngine
    from repro.serve import engine as je
    orig = blocks.moe_apply
    je._jitted_paged_steps_cached.cache_clear()
    try:
        if moe_apply is not None:
            blocks.moe_apply = moe_apply
        eng = JEngine(jp, jcfg, **KW)
        rids = [eng.submit(q, max_new=MAX_NEW) for q in _trace()]
        res = eng.run()
    finally:
        blocks.moe_apply = orig
        je._jitted_paged_steps_cached.cache_clear()
    return [np.asarray(res[r]).tolist() for r in rids]


@pytest.fixture(scope="module")
def runs():
    import concurrent.futures
    import jax
    from repro.models import init_model as j_init
    jc = {"ep": H.ref_cfg(ARCH), "non_ep": H.ref_cfg(ARCH, **NON_EP)}
    jp = {k: jax.tree_util.tree_map(np.asarray,
                                    j_init(jax.random.PRNGKey(0), c))
          for k, c in jc.items()}
    models = {k: (H.port_cfg(ARCH, **({} if k == "ep" else NON_EP)), jp[k],
                  _np_layer(jp[k])) for k in jc}
    d = jc["ep"].d_model
    rng = np.random.default_rng(5)
    layer_x = (rng.normal(size=(LAYER_B, LAYER_S, d)).astype(np.float32),
               rng.normal(size=(1, CHUNK, d)).astype(np.float32))
    st3 = H.ref_init(jc["non_ep"])
    bs = H.batches(jc["non_ep"].vocab_size, n=1)
    job = dict(name="non_ep", shape=(2, 2), cfg=models["non_ep"][0],
               state=st3, batches=bs, steps=1)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        def ranks():
            from repro_torch.parallel.mesh import run_ranks
            return {(2, 1): run_ranks(_rank, 1, {"ep": models["ep"]},
                                      layer_x, [], n_data=2, timeout=600),
                    (2, 2): run_ranks(_rank, 2, models, layer_x, [job],
                                      n_data=2, timeout=600)}
        fut = ex.submit(ranks)
        want = {"ep": _ref_serve(jp["ep"], jc["ep"], _shards_moe_apply(D)),
                "non_ep": _ref_serve(jp["non_ep"], jc["non_ep"])}
        train = H.ref_steps(jc["non_ep"], st3, bs)
        res = fut.result()
    return res, want, train, jc, models, layer_x


def _ref_layer(jcfg, p_np, x, n_shards):
    """The reference's ``dispatch_compute`` on ``n_shards`` shards of
    ``x``'s token rows at one shard's capacity: the output (B, S, d) and
    the (T, capacity, drops) of each shard."""
    import jax.numpy as jnp
    from repro.nn.moe import dispatch_compute, route
    p = {k: jnp.asarray(v) for k, v in p_np.items() if k != "router"}
    p["router"] = {"w": jnp.asarray(p_np["router"]["w"])}
    B, S, d = x.shape
    x2 = jnp.asarray(x.reshape(B * S, d))
    t = B * S // n_shards
    cap = max(4, int(jcfg.capacity_factor * t * jcfg.top_k
                     / jcfg.n_experts))
    outs, plans = [], []
    for i in range(0, B * S, t):
        idx, w, _ = route(p, x2[i:i + t], jcfg)
        outs.append(np.asarray(dispatch_compute(
            x2[i:i + t], idx, w, p["experts_wi"], p["experts_wg"],
            p["experts_wo"], n_experts_total=jcfg.n_experts, capacity=cap,
            act=jcfg.act, axis_name=None)))
        counts = np.bincount(np.asarray(idx).reshape(-1),
                             minlength=jcfg.n_experts)
        plans.append((t, cap, int(np.maximum(counts - cap, 0).sum())))
    return np.concatenate(outs).reshape(B, S, d), plans


CHECKS = [((2, 1), "ep"), ((2, 2), "ep"), ((2, 2), "non_ep")]


@pytest.mark.parametrize("shape, model", CHECKS,
                         ids=["2x1-ep", "2x2-ep", "2x2-non_ep"])
@pytest.mark.parametrize("call", ["split", "replicated"])
def test_layer_matches_reference_dispatch(runs, shape, model, call):
    """Under the reference's ep (EP, or a model axis of 1) each data
    shard is dispatched at ``t_local``: a split call's rows are its
    shard, a replicated call dispatches the D shards in turn.  Without
    EP one dispatch covers the whole batch at its capacity (a split call
    gathers the data rows' tokens)."""
    res, _, _, jc, models, layer_x = runs
    ep = model == "ep"
    x = layer_x[0] if call == "split" else layer_x[1]
    want, plans = _ref_layer(jc[model], models[model][2], x, D if ep else 1)
    rows = x.shape[0] // D if call == "split" else x.shape[0]
    for dr, _, got in res[shape][model]["layers"]:
        y, got_plans = got[call]
        lo = dr * rows if call == "split" else 0
        np.testing.assert_allclose(y, want[lo:lo + rows], rtol=1e-5,
                                   atol=1e-5)
        if ep and call == "split":
            assert got_plans == [plans[dr]]
        else:
            assert got_plans == plans
    if call == "replicated" and ep:
        assert sum(n for *_, n in plans) > 0      # t_local drops pairs


@pytest.mark.parametrize("shape, model", CHECKS,
                         ids=["2x1-ep", "2x2-ep", "2x2-non_ep"])
def test_replicated_call_that_d_does_not_divide(runs, shape, model):
    """A replicated call of 3 token rows: the reference's shard_map over
    2 data shards cannot run (refused, naming it); the global dispatch
    without EP needs no shards."""
    for *_, got in runs[0][shape][model]["layers"]:
        if model == "ep":
            assert "src/repro/nn/moe.py" in got["refusal"]
        else:
            assert got["refusal"] is None


@pytest.mark.parametrize("shape, model", CHECKS,
                         ids=["2x1-ep", "2x2-ep", "2x2-non_ep"])
def test_serve_matches_reference(runs, shape, model):
    """The engine's tokens: the reference's at ``t_local`` on each data
    shard (ep), its single-device engine's (no EP: global dispatch)."""
    res, want = runs[:2]
    r = res[shape][model]["serve"]
    assert r["agree"] and r["split"]
    assert r["tokens"] == want[model]


def test_non_ep_train_step_matches_single_device(runs):
    res, _, (mets, st, _) = runs[:3]
    r = res[(2, 2)]["train"]["non_ep"]
    assert abs(mets[0]["loss"] - r["losses"][0]) <= 5e-3
    assert abs(mets[0]["aux"] - r["aux"][0]) <= 1e-5
    H.assert_params_close(st["params"], r["state"]["params"], "non_ep",
                          **MOE_TOL)
    H.assert_params_close(st["opt"], r["state"]["opt"], "non_ep adafactor",
                          **MOE_TOL)
    assert r["agree"]
