"""Reduced qwen3-moe-235b-a22b (Adafactor, 8 experts top-2, q/k norms,
untied head) trained on a 2x2 mesh: 4 ranks over gloo on the CPU, each
data rank dispatching its own tokens to the model axis's experts (EP, 4
a rank).

* With ``capacity_factor`` 8 (no drops) 2 steps match the reference's
  single-device ``make_train_step`` within 5e-3 (the reference's EP
  tolerance, ``tests/multidevice_script.py``), its Adafactor moments
  reduced over the model axis where a shard cuts them.
* At the default capacity (drops), the port's MoE layer under 2x2 equals
  the reference's ``dispatch_compute`` run on each data block at the
  ``t_local`` capacity: the pairs each call drops are the same, outputs
  within 1e-5; the load-balance loss is the reference's over the global
  batch within 1e-6.  A 2x2 run at that capacity trains (finite losses,
  ranks agree).

The ranks are spawned once for the module; no rank process imports JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import torch_mesh_train as H  # noqa: E402

MOE_TOL = dict(rtol=5e-3, atol=5e-3)
LAYER_B, LAYER_S = 4, 16


def _layer(mesh, p_np, x_np):
    """The MoE layer on this rank's data block and experts: (data rank,
    model rank, output, pairs dropped, aux) of every rank."""
    import torch.distributed as dist
    from repro_torch.nn.moe import capacity, dispatch_plan, moe_apply, route
    from repro_torch.parallel.mesh import set_mesh
    cfg = H.port_cfg(H.MOE_ARCH)
    E, tp = cfg.n_experts, mesh.n_model
    p = {"router": {"w": torch.from_numpy(p_np["router"]["w"])}}
    for k in ("experts_wi", "experts_wg", "experts_wo"):
        n = E // tp
        p[k] = torch.from_numpy(p_np[k][mesh.model_rank * n:
                                        (mesh.model_rank + 1) * n])
    rows = x_np.shape[0] // mesh.n_data
    x = torch.from_numpy(x_np[mesh.data_rank * rows:
                              (mesh.data_rank + 1) * rows])
    with torch.no_grad(), set_mesh(mesh):
        out, aux = moe_apply(p, x, cfg)
        x2 = x.reshape(-1, x.shape[-1])
        idx, _, _ = route(p, x2, cfg)
        keep = dispatch_plan(idx, E, capacity(cfg, x2.shape[0]))[2]
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (mesh.data_rank, mesh.model_rank,
                                 out.numpy(), int((~keep).sum()),
                                 float(aux)))
    return got


def _rank(mesh, jobs, layer):
    out = H.train_jobs(mesh, jobs)
    out["layer"] = _layer(mesh, *layer)
    return out


@pytest.fixture(scope="module")
def runs():
    jc8 = H.ref_cfg(H.MOE_ARCH, capacity_factor=8.0)
    jcd = H.ref_cfg(H.MOE_ARCH)
    s8 = H.ref_init(jc8)
    bs = H.batches(jc8.vocab_size)
    jobs = [dict(name="cf8", shape=(2, 2), state=s8, batches=bs,
                 cfg=H.port_cfg(H.MOE_ARCH, capacity_factor=8.0)),
            dict(name="drops", shape=(2, 2), state=H.ref_init(jcd),
                 batches=bs, cfg=H.port_cfg(H.MOE_ARCH))]
    p_np = s8["params"]["moe_stack"]["moe"]
    p_np = {"router": {"w": p_np["router"]["w"][0]},
            **{k: p_np[k][0] for k in ("experts_wi", "experts_wg",
                                       "experts_wo")}}
    x = np.random.default_rng(5).normal(
        size=(LAYER_B, LAYER_S, jc8.d_model)).astype(np.float32)
    res, ref = H.with_ranks(_rank, 2, jobs,
                            lambda: H.ref_steps(jc8, s8, bs), n_data=2,
                            extra=((p_np, x),))
    return res, ref, jcd, p_np, x


def test_no_drop_steps_match_single_device(runs):
    res, (mets, st, _) = runs[:2]
    r = res["cf8"]
    for m, loss in zip(mets, r["losses"]):
        assert abs(m["loss"] - loss) <= 5e-3
    H.assert_params_close(st["params"], r["state"]["params"], "cf8",
                          **MOE_TOL)
    H.assert_params_close(st["opt"], r["state"]["opt"], "cf8 adafactor",
                          **MOE_TOL)
    assert r["agree"]


def test_trains_with_drops(runs):
    r = runs[0]["drops"]
    assert np.isfinite(r["losses"]).all() and r["agree"]


def _drops(idx: np.ndarray, n_experts: int, cap: int) -> int:
    counts = np.bincount(idx.reshape(-1), minlength=n_experts)
    return int(np.maximum(counts - cap, 0).sum())


def test_layer_matches_reference_per_data_block(runs):
    import jax.numpy as jnp
    from repro.nn.moe import dispatch_compute, route
    res, _, jcfg, p_np, x = runs
    got = res["layer"]
    p = {k: jnp.asarray(v) for k, v in p_np.items() if k != "router"}
    p["router"] = {"w": jnp.asarray(p_np["router"]["w"])}
    D = 2
    rows = LAYER_B // D
    t_local = rows * LAYER_S
    cap = max(4, int(jcfg.capacity_factor * t_local * jcfg.top_k
                     / jcfg.n_experts))
    total_drops = 0
    for d in range(D):
        x2 = jnp.asarray(x[d * rows:(d + 1) * rows].reshape(t_local, -1))
        idx, w, _ = route(p, x2, jcfg)
        want = np.asarray(dispatch_compute(
            x2, idx, w, p["experts_wi"], p["experts_wg"], p["experts_wo"],
            n_experts_total=jcfg.n_experts, capacity=cap, act=jcfg.act,
            axis_name=None)).reshape(rows, LAYER_S, -1)
        drops = _drops(np.asarray(idx), jcfg.n_experts, cap)
        total_drops += drops
        for dr, _, out, n_drop, _ in got:
            if dr == d:
                np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
                assert n_drop == drops
    assert total_drops > 0          # the default capacity drops pairs
    _, _, aux = route(p, jnp.asarray(x.reshape(LAYER_B * LAYER_S, -1)), jcfg)
    for *_, a in got:
        assert abs(a - float(aux)) <= 1e-6
