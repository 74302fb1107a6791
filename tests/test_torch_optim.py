"""Port parity for the optimizers, the LR schedule, clipping and the int8
gradient compression (``repro_torch.optim``) against ``repro.optim``, on
a mixed-rank tree made from numpy seeds, on the CPU.

Tolerances: params and optimizer state within rtol 1e-6 (atol 1e-9) after
5 updates, against the reference's update run op by op (compiled, XLA
contracts products and sums into fused multiply-adds, which the trainer
tests cover);
``warmup_cosine`` bit for bit against the reference's compiled schedule;
clipping within rtol 1e-6; int8 codes and scales bit for bit, error
buffers within rtol 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as J  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro.optim.clip import global_norm as j_global_norm  # noqa: E402

from repro_torch import optim as T  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402
from repro_torch.tree import (tree_flatten, tree_leaves,  # noqa: E402
                              tree_map, tree_unflatten)

RTOL = 1e-6


def _tree(seed: int) -> dict:
    """A mixed-rank tree: a stacked (L, k, n) matrix, a matrix, vectors, a
    scalar, nested dicts with unsorted keys."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"w": f(6, 5), "stack": {"wq": f(2, 4, 3), "g": f(2, 4),
                                    "as": f(2)},
            "b": f(5), "a_scale": f()}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def _close(jt, tt, rtol=RTOL, atol=1e-9):
    jl = jax.tree_util.tree_leaves(jt)
    tl = tree_leaves(tt)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert np.asarray(a).shape == b.shape
        np.testing.assert_allclose(b, np.asarray(a), rtol=rtol, atol=atol)


def test_tree_flatten_order_is_jax_order():
    tree = {"z": {"b": 1, "a": (2, [3, None, 4])}, "m": 5, "a": {"y": 6}}
    leaves, spec = tree_flatten(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert tree_unflatten(spec, leaves) == tree


@pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
def test_optimizer_matches_reference(name):
    p0 = _tree(0)
    jopt, topt = J.make_optimizer(name), T.make_optimizer(name)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = _to_torch(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    _close(js, ts)
    jupd = jopt.update
    for i in range(5):
        g = _tree(10 + i)
        lr = 3e-3 * (i + 1)
        jp, js = jupd(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr)
        tp, ts = topt.update(_to_torch(g), ts, tp, lr)
    _close(jp, tp)
    _close(js, ts)
    # the state's leaves are the reference's, one for one (checkpoints)
    assert [np.asarray(a).shape for a in jax.tree_util.tree_leaves(js)] == \
        [tuple(b.shape) for b in tree_leaves(ts)]


@pytest.mark.parametrize("base_lr,warmup,total", [
    (3e-4, 100, 2000), (3e-4, 2, 20), (1e-3, 5, 60), (3e-3, 0, 60),
    (3e-4, 7, 3)])
def test_warmup_cosine_bit_exact(base_lr, warmup, total):
    """Against the reference's schedule as its train step runs it (in one
    compiled program): every step's rate bit for bit in f32."""
    jlr = jax.jit(J.warmup_cosine(base_lr, warmup, total))
    tlr = T.warmup_cosine(base_lr, warmup, total)
    steps = np.arange(0, total + 5, dtype=np.int32)
    ref = np.asarray(jax.vmap(jlr)(jnp.asarray(steps)))
    got = np.asarray([tlr(int(s)) for s in steps], np.float32)
    np.testing.assert_array_equal(got, ref)
    assert tlr(torch.tensor(min(3, total), dtype=torch.int32)) == \
        got[min(3, total)]


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches(max_norm):
    g = _tree(3)
    jg, jn = J.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, g),
                                   max_norm)
    tg, tn = T.clip_by_global_norm(_to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    np.testing.assert_allclose(float(T.global_norm(_to_torch(g))),
                               float(j_global_norm(g)), rtol=RTOL)
    _close(jg, tg)


def test_compress_int8_bit_exact():
    rng = np.random.default_rng(4)
    for x in (rng.normal(size=(7, 9)).astype(np.float32) * 3,
              np.zeros((4,), np.float32),
              np.asarray([127.0, -254.0, 0.5, 1.5], np.float32)):
        jc, js = JC.compress_int8(jnp.asarray(x))
        tc, ts = TC.compress_int8(torch.from_numpy(x))
        assert tc.dtype == torch.int8
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(TC.decompress_int8(tc, ts).numpy(),
                                      np.asarray(JC.decompress_int8(jc, js)))


def test_ef_compress_tree_matches():
    g = _tree(5)
    je = JC.init_error_buffers(jax.tree_util.tree_map(jnp.asarray, g))
    te = TC.init_error_buffers(_to_torch(g))
    _close(je, te)
    for i in range(3):
        g = _tree(6 + i)
        jc, js, je = JC.ef_compress_tree(
            jax.tree_util.tree_map(jnp.asarray, g), je)
        tc, ts, te = TC.ef_compress_tree(_to_torch(g), te)
        for a, b in zip(jax.tree_util.tree_leaves(jc), tree_leaves(tc)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        _close(js, ts, rtol=0, atol=0)
        _close(je, te)
