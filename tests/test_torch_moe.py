"""Port parity for ``repro_torch.nn.moe`` against ``repro.nn.moe`` on the
CPU, from numpy inputs made from a seed: ``route`` for the softmax router
(switch-style aux) and the sigmoid router (selection on ``scores +
bias``, weights from the unbiased scores), with planted top-k ties that
must keep the lower expert first; ``dispatch_compute`` at a capacity
that drops, with the drop set; and ``moe_apply`` with a shared expert, in
f32 and with bf16 expert weights.

Tolerances: routing indices exact; routing weights and aux within rtol
1e-5 / atol 1e-7 (one f32 product and softmax in another order: 2e-6
relative measured where the planted ties scale the logits 4x);
dispatch outputs within rtol 1e-5 / atol 1e-6 (f32 products of 64-wide
rows, combined in the reference's scatter order); moe_apply within rtol
1e-5 / atol 1e-5 (bf16 weights: the hidden state is rounded to bf16 before
``wo``, so an f32 difference can move one rounding: atol 1e-4).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.nn import moe as J  # noqa: E402

from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models.lm import _convert  # noqa: E402
from repro_torch.nn import moe as T  # noqa: E402

QWEN, DSV3 = "qwen3-moe-235b-a22b", "deepseek-v3-671b"


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget(arch).reduced(), **kw),
            dataclasses.replace(tget(arch).reduced(), **kw))


def _params(jc, seed=0):
    jp = jax.tree_util.tree_map(np.asarray,
                                J.moe_init(jax.random.PRNGKey(seed), jc))
    return jp, _convert(jp, torch.device("cpu"))


def _x(T_, d, seed=1):
    return np.random.default_rng(seed).normal(size=(T_, d)).astype(
        np.float32)


@pytest.mark.parametrize("arch", [QWEN, DSV3])
def test_route_matches_reference(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    x = _x(37, jc.d_model)
    ji, jw, ja = J.route(jp, jnp.asarray(x), jc)
    ti, tw, ta = T.route(tp, torch.from_numpy(x), tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    if jc.router_type == "sigmoid":
        assert float(ta) == 0.0


@pytest.mark.parametrize("arch", [QWEN, DSV3])
def test_route_ties_keep_the_lower_expert_first(arch):
    """Experts 2, 5 and 6 get the same router column, so every token's
    scores tie among them exactly; top-k must list them lower index
    first, as ``lax.top_k`` does (``torch.topk`` does not promise it).
    The sigmoid router also ties experts 1 and 4."""
    jc, tc = _cfgs(arch, top_k=4)
    jp, _ = _params(jc)
    w = np.array(jp["router"]["w"])
    w[:, 2] *= 4.0                       # the tied trio wins often
    w[:, 5] = w[:, 2]
    w[:, 6] = w[:, 2]
    if jc.router_type == "sigmoid":
        w[:, 4] = w[:, 1]                # bias 0: scores + bias tie too
    jp = dict(jp, router=dict(jp["router"], w=w))
    tp = _convert(jp, torch.device("cpu"))
    x = _x(64, jc.d_model, seed=3)
    ji, jw, _ = J.route(jp, jnp.asarray(x), jc)
    ti, tw, _ = T.route(tp, torch.from_numpy(x), tc)
    ji = np.asarray(ji)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)
    # the ties were exercised: a row that holds two of the tied trio
    trio = np.isin(ji, [2, 5, 6]).sum(1)
    assert (trio >= 2).any()
    for row in ji[trio >= 2]:
        pos = [list(row).index(e) for e in (2, 5, 6) if e in row]
        assert pos == sorted(pos)


def _drops_reference(idx, E, cap):
    """The reference's keep mask (``dispatch_compute``'s sort, counts and
    ranks, lines 104-115), mapped back to (token, choice)."""
    key = idx.reshape(-1)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    counts = np.bincount(key_s, minlength=E)
    starts = np.cumsum(counts) - counts
    rank = np.arange(key.size) - starts[key_s]
    keep = rank < cap
    out = np.empty(key.size, bool)
    out[order] = ~keep
    return out.reshape(idx.shape)


@pytest.mark.parametrize("cap", [1, 2, 3, 40])
def test_dispatch_drops_match_reference(cap):
    """At capacities 1-3 many (token, choice) pairs are dropped (a token
    whose every choice is dropped gets 0); at 40 none is."""
    jc, tc = _cfgs(QWEN)
    jp, tp = _params(jc)
    x = _x(20, jc.d_model, seed=4)
    ji, jw, _ = J.route(jp, jnp.asarray(x), jc)
    ji, jw = np.array(ji), np.array(jw)
    want = J.dispatch_compute(
        jnp.asarray(x), jnp.asarray(ji), jnp.asarray(jw),
        jp["experts_wi"], jp["experts_wg"], jp["experts_wo"],
        n_experts_total=jc.n_experts, capacity=cap, act=jc.act,
        axis_name=None)
    got = T.dispatch_compute(
        torch.from_numpy(x), torch.from_numpy(ji), torch.from_numpy(jw),
        tp["experts_wi"], tp["experts_wg"], tp["experts_wo"],
        capacity=cap, act=tc.act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    order, _, keep, _ = T.dispatch_plan(torch.from_numpy(ji), jc.n_experts,
                                        cap)
    drop = np.empty(ji.size, bool)
    drop[order.numpy()] = ~keep.numpy()
    drop = drop.reshape(ji.shape)
    np.testing.assert_array_equal(drop, _drops_reference(ji, jc.n_experts,
                                                         cap))
    if cap < 4:
        assert drop.any()
        dead = drop.all(1)
        np.testing.assert_array_equal(got.numpy()[dead], 0.0)
    else:
        assert not drop.any()


def test_capacity_matches_reference():
    jc, tc = _cfgs(QWEN)
    full = tget(QWEN)
    for n in (1, 4, 32, 884, 4096):
        want = max(4, int(jc.capacity_factor * n * jc.top_k
                          / jc.n_experts))
        assert T.capacity(tc, n) == want
    assert T.capacity(full, 32) == 4 and T.capacity(full, 884) == 69


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [QWEN, DSV3])
def test_moe_apply_matches_reference(arch, pdtype):
    jc, tc = _cfgs(arch, param_dtype=pdtype)
    jp, tp = _params(jc, seed=2)
    x = np.random.default_rng(6).normal(size=(3, 11, jc.d_model)) \
        .astype(np.float32)
    jo, ja = J.moe_apply(jp, jnp.asarray(x), jc)
    to, ta = T.moe_apply(tp, torch.from_numpy(x), tc)
    atol = 1e-5 if pdtype == "float32" else 1e-4
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=atol)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    if arch == DSV3:
        assert "shared" in tp


def test_expert_chunks_equal_one_pass(monkeypatch):
    """bf16 expert stacks are cast to f32 a chunk of experts at a time;
    any chunk size gives the one-pass result bit for bit."""
    _, tc = _cfgs(DSV3, param_dtype="bfloat16")
    jc, _ = _cfgs(DSV3, param_dtype="bfloat16")
    _, tp = _params(jc, seed=3)
    buf = torch.from_numpy(np.random.default_rng(7).normal(
        size=(jc.n_experts, 5, jc.d_model)).astype(np.float32))
    args = (tp["experts_wi"], tp["experts_wg"], tp["experts_wo"], buf,
            tc.act)
    whole = T._expert_ffn_local(*args)
    per_expert = jc.d_model * jc.d_ff_expert * 4
    for n in (1, 3):
        monkeypatch.setattr(T, "_CAST_BYTES", n * per_expert)
        assert torch.equal(T._expert_ffn_local(*args), whole)


def test_moe_forward_and_backward_run_in_graph_friendly_ops():
    """The MoE layer is differentiable (router weights, experts, shared
    expert) and its sigmoid bias gets no gradient, as in the
    reference."""
    _, tc = _cfgs(DSV3)
    jc, _ = _cfgs(DSV3)
    _, tp = _params(jc, seed=4)
    leaves = {"w": tp["router"]["w"], "b": tp["router"]["bias"],
              "wi": tp["experts_wi"], "s": tp["shared"]["wi"]}
    for t in leaves.values():
        t.requires_grad_(True)
    x = torch.from_numpy(_x(12, jc.d_model, seed=8)).reshape(2, 6, -1)
    out, _ = T.moe_apply(tp, x, tc)
    g = torch.autograd.grad(out.square().sum(), list(leaves.values()),
                            allow_unused=True)
    grads = dict(zip(leaves, g))
    assert grads["b"] is None
    for k in ("w", "wi", "s"):
        assert grads[k] is not None and bool(grads[k].abs().sum() > 0)
