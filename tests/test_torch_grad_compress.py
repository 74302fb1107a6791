"""The int8 error-feedback gradient all-reduce (``grad_compress``) on 2
ranks (gloo, the CPU), reduced qwen1.5-0.5b, 2 steps.

The reference's step under a mesh quantizes the clipped global gradient
(its gradients reach the ``shard_map`` already reduced), so its numbers
are those of the single-device chain ``jax.grad`` → ``clip_by_global_norm``
→ ``ef_compress_tree`` → ``decompress_int8`` → ``adamw``, which this file
runs as the oracle.  On a 2x1 mesh (data parallel) the port's int8 codes
equal the chain's except where a value lies within 1e-3 of a .5 rounding
boundary (counted and located), the decompressed gradients agree within
1e-5 elsewhere, the error buffer is non-zero and the same on every rank,
and one step lies within 5e-3 of the uncompressed step (the reference's
check).  A 1x2 mesh quantizes too ("data" is an axis of every reference
mesh), at each whole leaf's scale.

The ranks are spawned once for the module; no rank process imports JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_train as H  # noqa: E402

JOBS = {"dp2": (2, 1), "tp2": (1, 2)}
EDGE_TOL = 1e-3


def _rank(mesh, jobs):
    return H.train_jobs(mesh, jobs)


def _chain(jcfg, state, bs):
    """The reference's primitives, chained as its step under a mesh
    chains them: per step (codes, corrected gradient over its scale,
    decompressed gradient) as lists of leaves, and the final state."""
    import jax
    import jax.numpy as jnp
    from repro.models import apply_model
    from repro.optim import clip_by_global_norm, make_optimizer, \
        warmup_cosine
    from repro.optim.compression import decompress_int8, ef_compress_tree
    from repro.train.losses import lm_loss
    opt = make_optimizer(jcfg.optimizer)
    lr_fn = warmup_cosine(jcfg.learning_rate, H.WARMUP, H.TOTAL)
    tm = jax.tree_util.tree_map

    def loss_fn(p, b):
        logits, _, aux = apply_model(p, jcfg, b["tokens"])
        return lm_loss(logits, b["labels"]) + jcfg.aux_loss_weight * aux

    @jax.jit
    def step(st, b):
        g, _ = clip_by_global_norm(jax.grad(loss_fn)(st["params"], b), 1.0)
        codes, scales, err = ef_compress_tree(g, st["err"])
        over = tm(lambda g_, e, s_: (g_.astype(jnp.float32) + e) / s_, g,
                  st["err"], scales)
        g2 = tm(decompress_int8, codes, scales)
        p, o = opt.update(g2, st["opt"], st["params"], lr_fn(st["step"]))
        return dict(st, params=p, opt=o, err=err, step=st["step"] + 1), (
            codes, over, g2, scales)

    st = tm(jnp.asarray, state)
    per = []
    for b in bs:
        st, out = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        per.append([[np.asarray(x) for x in jax.tree_util.tree_leaves(t)]
                    for t in out])
    return per, tm(np.asarray, st)


@pytest.fixture(scope="module")
def runs():
    jcfg = H.ref_cfg()
    state = H.ref_init(jcfg, grad_compress=True)
    bs = H.batches(jcfg.vocab_size)
    jobs = [dict(name=k, shape=v, cfg=H.port_cfg(), state=state, batches=bs,
                 grad_compress=True) for k, v in JOBS.items()]
    jobs.append(dict(name="dp2_1", shape=(2, 1), cfg=H.port_cfg(),
                     state=state, batches=bs, steps=1, grad_compress=True))
    return H.with_ranks(_rank, 1, jobs, lambda: (
        _chain(jcfg, state, bs), H.ref_steps(jcfg, state, bs[:1])),
        n_data=2)


def _codes_apart(per, r):
    """Every (step, leaf, element, value over scale) whose code differs
    from the chain's, and their count.  A code
    apart must lie within ``EDGE_TOL`` of a .5 boundary, or sit where a
    code was apart at an earlier step: error feedback carries the other
    rounding into the next step's value there.  The decompressed
    gradients agree within 1e-5 wherever the codes agree."""
    apart, moved, total = [], set(), 0
    for i, (codes, over, g2, _) in enumerate(per):
        for li, (c_ref, v, g_ref, c, g) in enumerate(zip(
                codes, over, g2, r["codes"][i], r["g2"][i])):
            total += c.size
            for j in np.flatnonzero(c_ref != c):
                e = H.edge(float(v.flat[j]))
                assert e <= EDGE_TOL or (li, j) in moved, (
                    f"step {i} leaf {li} element {j}: code {c.flat[j]} vs "
                    f"{c_ref.flat[j]}, {e} from .5")
                apart.append((i, li, int(j), float(v.flat[j])))
                moved.add((li, j))
            same = c_ref == c
            np.testing.assert_allclose(g[same], g_ref[same], rtol=1e-5,
                                       atol=1e-12)
    return apart, total


def test_codes_match_the_reference_chain(runs):
    res, ((per, _), _) = runs
    r = res["dp2"]
    assert len(r["codes"]) == H.STEPS
    apart, total = _codes_apart(per, r)
    print(f"{len(apart)} of {total} codes apart (step, leaf, element, value "
          f"over scale): {apart[:8]}")


@pytest.mark.parametrize("name", sorted(JOBS))
def test_state_follows_the_chain(runs, name):
    res, ((per, chain_state), _) = runs
    r = res[name]
    H.assert_params_close(chain_state["params"], r["state"]["params"], name)
    # the error buffers agree except where a code was apart: there they
    # differ by at most one quantum (the last step's scale) that feedback
    # carries, in at most 1e-3 of the elements
    scales = per[-1][3]
    n_apart = n_all = 0
    for li, (a, b) in enumerate(zip(H.leaves(chain_state["err"]),
                                    H.leaves(r["state"]["err"]))):
        bad = np.abs(b - a) > 1e-6 + 1e-3 * np.abs(a)
        assert (np.abs(b - a)[bad] <= 1.01 * float(scales[li])).all(), name
        n_apart += int(bad.sum())
        n_all += a.size
    assert n_apart <= 1e-3 * n_all, (name, n_apart)
    print(f"{name}: error buffers apart by a quantum at {n_apart} of "
          f"{n_all} elements")
    assert r["agree"] and r["err_agree"]
    assert any(np.abs(x).max() > 0 for x in H.leaves(r["state"]["err"]))


def test_one_step_near_the_uncompressed_step(runs):
    """The reference's check: one compressed step within 5e-3 of the
    uncompressed one (a 1-step run of the same job)."""
    res, (_, (_, plain, _)) = runs
    worst = 0.0
    for a, b in zip(H.leaves(plain["params"]),
                    H.leaves(res["dp2_1"]["state"]["params"])):
        worst = max(worst, float(np.abs(a - b).max()))
    assert worst < 5e-3, worst
    assert res["dp2_1"]["agree"]
