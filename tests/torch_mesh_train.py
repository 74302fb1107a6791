"""Shared parts of the several-rank training tests (``tests/test_torch_
{dp,tp,moe_dp}_train.py``, ``test_torch_grad_compress.py``,
``test_torch_elastic.py``, ``test_torch_pipeline.py``): the configs, the
batches, the rank function that runs a list of training jobs on its mesh
(``train_jobs``), the reference's single-device oracle and the
comparisons.

A rank process imports this module by name, so JAX is imported only
inside the functions the parent runs (``ref_*``).  Every job starts from
the reference's ``init_train_state`` (numpy leaves), cut for the job's
mesh; every rank gets the same global batches.  Tolerances are the
reference's mesh tests' (``tests/multidevice_script.py``): params within
rtol = atol = 2e-3, losses within 1e-3.  Two steps move a param by less
than that atol (the first at lr 0 under the warm-up), so the optimizer
state is compared too, leaf by leaf within 1e-5 of the leaf's max: AdamW's
``m`` and ``v`` hold each step's clipped gradient, where a wrong gradient
shows.
"""
import dataclasses

import numpy as np

ARCH = "qwen1.5-0.5b"
MOE_ARCH = "qwen3-moe-235b-a22b"
B, S = 8, 16                    # global batch rows, sequence
STEPS = 2
WARMUP, TOTAL = 2, 20
PARAM_TOL = dict(rtol=2e-3, atol=2e-3)
LOSS_TOL = 1e-3
# optimizer state: within this share of each leaf's max |value|
MOMENT_TOL = 1e-5
# a parting's first differing int8 code: within this of a .5 boundary
ORIGIN_TOL = 1e-3
# per layer, the order in which the forward calls the linears
CALLS = (("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
         ("mlp", "wi"), ("mlp", "wg"), ("mlp", "wo"))


def port_cfg(arch=ARCH, mode="fp", mac=None, **kw):
    from repro_torch.configs import get_config
    from repro_torch.core.layers import MacConfig
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    if mode != "fp":
        cfg = dataclasses.replace(cfg, mac=MacConfig(mode=mode, mac=mac))
    return cfg


def batches(vocab, n=STEPS, rows=B, seq=S, seed=0):
    from repro_torch.data import SyntheticLMDataset
    ds = SyntheticLMDataset(vocab, seq, seed=seed)
    return [ds.batch(i, rows) for i in range(n)]


def np_tree(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


# --- the ranks ---------------------------------------------------------------

def _record(mesh, params, cfg, tokens):
    """Every linear's input over its activation scale, forward order, the
    row linears' inputs gathered over the model axis (``CALLS`` order)."""
    import torch
    from repro_torch.models import apply_model, unstack_layers
    from repro_torch.nn.common import activation_recorder
    from repro_torch.parallel.mesh import set_mesh
    xs = []

    def hook(name, w, x):
        if name == "wo" and mesh.n_model > 1:
            x = mesh.gather_columns(x.contiguous())
        xs.append(x.float().numpy().copy())
    with torch.no_grad(), set_mesh(mesh), activation_recorder(hook):
        apply_model(unstack_layers(params), cfg, torch.as_tensor(tokens))
    return _over_scale(xs, np_tree(params)["stack"])


def _over_scale(xs, stack):
    assert len(xs) % len(CALLS) == 0
    out = []
    for c, x in enumerate(xs):
        sub, name = CALLS[c % len(CALLS)]
        sa = np.asarray(stack[sub][name + "_as"])[c // len(CALLS)]
        out.append((f"layer {c // len(CALLS)} {sub}/{name}",
                    np.asarray(x, np.float32) / np.float32(sa)))
    return out


def train_jobs(mesh, jobs):
    """Each job on this rank: ``{"name", "shape": (D, M), "cfg", "state"
    (the reference's logical state, numpy), "batches", "steps"[,
    "grad_compress", "microbatch", "record", "save", "restore"]}``.  A
    mesh per shape, made in job order on every rank.  Returns per job the
    losses, gnorms and aux, the logical state after the steps (numpy),
    whether every rank holds that state, the collectives, and with
    ``grad_compress`` each step's int8 codes (whole leaves: data-only
    meshes) and decompressed gradients."""
    import pickle
    import torch.distributed as dist
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.models import train_state_from_jax
    from repro_torch.optim.compression import ef_compress_tree
    from repro_torch.parallel.mesh import Mesh, set_mesh
    from repro_torch.parallel.statesharding import gather_state, shard_state
    from repro_torch.train import make_train_step
    from repro_torch.train import trainer as T
    from repro_torch.tree import tree_leaves
    meshes, out = {}, {}
    for job in jobs:
        shape = tuple(job["shape"])
        if shape not in meshes:
            meshes[shape] = mesh if shape == (mesh.n_data, mesh.n_model) \
                else Mesh(*shape)
        m, cfg = meshes[shape], job["cfg"]
        state = train_state_from_jax(job["state"], "cpu")
        if job.get("restore"):
            state = restore_checkpoint(job["restore"][0], job["restore"][1],
                                       state)
        st = shard_state(state, cfg, m)
        step = make_train_step(cfg, warmup=WARMUP, total_steps=TOTAL,
                               microbatch=job.get("microbatch"),
                               grad_compress=job.get("grad_compress", False))
        res = {"losses": [], "gnorms": [], "aux": [], "records": [],
               "codes": [], "g2": []}
        orig = T.compressed_allreduce

        def recorded(grads, err, mesh_):
            codes, _, _ = ef_compress_tree(grads, err,
                                           reduce_amax=mesh_.all_reduce_max)
            g2, e2 = orig(grads, err, mesh_)
            res["codes"].append([c.numpy().copy()
                                 for c in tree_leaves(codes)])
            res["g2"].append([g.numpy().copy() for g in tree_leaves(g2)])
            return g2, e2
        T.compressed_allreduce = recorded
        c0 = m.counters()
        try:
            with set_mesh(m):
                for b in job["batches"][:job.get("steps", STEPS)]:
                    if job.get("record"):
                        res["records"].append(_record(m, st["params"], cfg,
                                                      b["tokens"]))
                    st, met = step(st, b)
                    res["losses"].append(float(met["loss"]))
                    res["gnorms"].append(float(met["gnorm"]))
                    res["aux"].append(float(met["aux"]))
        finally:
            T.compressed_allreduce = orig
        c1 = m.counters()
        res["collectives"] = (c1[0] - c0[0], c1[2] - c0[2])
        whole = gather_state(st, cfg, m)
        res["state"] = np_tree(whole)
        res["agree"] = m.agree([np.asarray(x) for x in
                                tree_leaves(res["state"])])
        if "err" in st:
            # every data rank holds the same shards of the error buffers
            mine = pickle.dumps([x.numpy() for x in tree_leaves(st["err"])])
            got = [None] * dist.get_world_size()
            dist.all_gather_object(got, (m.model_rank, mine))
            res["err_agree"] = all(g == mine for r_, g in got
                                   if r_ == m.model_rank)
        if job.get("save"):
            if m.rank == 0:
                save_checkpoint(job["save"][0], job["save"][1], whole)
            m.barrier()
        out[job["name"]] = res
        del st, whole
    return out


# --- the parent: the reference's single-device oracle ------------------------

def ref_cfg(arch=ARCH, mode="fp", mac=None, **kw):
    from repro.configs import get_config
    from repro.core.layers import MacConfig
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    if mode != "fp":
        cfg = dataclasses.replace(cfg, mac=MacConfig(mode=mode, mac=mac))
    return cfg


def ref_init(jcfg, seed=0, grad_compress=False):
    """The reference's initial train state, numpy leaves."""
    import jax
    from repro.train import init_train_state
    st = init_train_state(jax.random.PRNGKey(seed), jcfg,
                          grad_compress=grad_compress)
    return jax.tree_util.tree_map(np.asarray, st)


def ref_steps(jcfg, state, bs, **kw):
    """The reference's jitted single-device steps over ``bs``: per step
    its metrics (floats), the state after the last step, and the states
    before each step (numpy)."""
    import jax
    import jax.numpy as jnp
    from repro.train import make_train_step
    step = jax.jit(make_train_step(jcfg, warmup=WARMUP, total_steps=TOTAL,
                                   **kw))
    st = jax.tree_util.tree_map(jnp.asarray, state)
    mets, befores = [], []
    for b in bs:
        befores.append(jax.tree_util.tree_map(np.asarray, st))
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        mets.append({k: float(v) for k, v in m.items()})
    return mets, jax.tree_util.tree_map(np.asarray, st), befores


def with_ranks(fn, n_model, jobs, ref_fn, n_data=1, extra=()):
    """``run_ranks(fn, n_model, jobs, *extra, n_data=)`` while this
    process computes ``ref_fn()`` (the reference's oracle) → (ranks'
    result, ``ref_fn()``'s)."""
    import concurrent.futures
    from repro_torch.parallel.mesh import run_ranks
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_ranks, fn, n_model, jobs, *extra, n_data=n_data,
                        timeout=600)
        ref = ref_fn()
        return fut.result(), ref


def ref_record(jparams, jcfg, tokens):
    import jax.numpy as jnp
    from repro.models import apply_model
    from repro.nn.common import set_activation_recorder
    cfg = dataclasses.replace(jcfg, scan_layers=False, remat=False)
    xs = []
    prev = set_activation_recorder(lambda n, w, x: xs.append(np.asarray(x)))
    try:
        apply_model(jparams, cfg, jnp.asarray(tokens))
    finally:
        set_activation_recorder(prev)
    return _over_scale(xs, jparams["stack"])


def leaves(tree):
    from repro_torch.tree import tree_leaves
    return [np.asarray(x) for x in tree_leaves(tree)]


def assert_params_close(ref_params, port_params, what, **tol):
    for a, b in zip(leaves(ref_params), leaves(port_params)):
        np.testing.assert_allclose(np.asarray(b, np.float32),
                                   np.asarray(a, np.float32), err_msg=what,
                                   **(tol or PARAM_TOL))


def assert_moments_close(ref_opt, port_opt, what):
    """Each optimizer-state leaf within ``MOMENT_TOL`` of its max |value|
    (the reference's leaf) everywhere."""
    for i, (a, b) in enumerate(zip(leaves(ref_opt), leaves(port_opt))):
        a = np.asarray(a, np.float64)
        d = np.abs(np.asarray(b, np.float64) - a).max(initial=0.0)
        tol = MOMENT_TOL * np.abs(a).max(initial=0.0)
        assert d <= tol, f"{what}: optimizer leaf {i} {a.shape} apart by " \
            f"{d:.3e} > {tol:.3e}"


def edge(v: float) -> float:
    """Distance of ``v`` from the nearest .5 rounding boundary."""
    return abs(v - (np.floor(v) + 0.5))


def first_code_flip(ref, port):
    """The first linear input (forward order) and element where two
    forwards' int8 codes differ: (site, ref value, port value), or
    None."""
    for (site, a), (_, b) in zip(ref, port):
        ca = np.clip(np.round(a), -127, 127)
        cb = np.clip(np.round(b), -127, 127)
        diff = np.flatnonzero(ca != cb)
        if diff.size:
            i = diff[0]
            return site, float(a.flat[i]), float(b.flat[i])
    return None


def check_against_ref(ref, res, what, jcfg=None, batches=None):
    """A job's losses, final params and optimizer state against the
    reference's ``ref`` (``ref_steps``'s output).  ``jcfg``/``batches``
    given (an int8 or encoded run, ``record`` on): where the two part,
    the parting must start at an int8 code within ``ORIGIN_TOL`` of a .5
    boundary, found by reading the reference's forward before each step
    (from its state then) against the job's recorded one.  Returns that code's (step,
    (site, ref value, job value)), or None where they do not part."""
    mets, ref_state, befores = ref
    parted = next((i for i, m in enumerate(mets)
                   if abs(m["loss"] - res["losses"][i]) > LOSS_TOL), None)
    if parted is None:
        try:
            assert_params_close(ref_state["params"], res["state"]["params"],
                                what)
            assert_moments_close(ref_state["opt"], res["state"]["opt"], what)
            return None
        except AssertionError:
            if jcfg is None:
                raise
            parted = len(mets) - 1
    assert jcfg is not None, f"{what}: loss parts at step {parted}"
    flip = next(((j, f) for j in range(parted + 1) for f in [
        first_code_flip(ref_record(befores[j]["params"], jcfg,
                                   batches[j]["tokens"]),
                        res["records"][j])] if f is not None), None)
    assert flip is not None, f"{what}: parts at step {parted} with no " \
        "int8 code apart"
    _, (site, a, b) = flip
    assert edge(a) <= ORIGIN_TOL and edge(b) <= ORIGIN_TOL, \
        f"{what}: first code apart at {site}: {a} vs {b}"
    return flip
