"""Training on a 2x2 mesh (data x model, 4 ranks over gloo, the CPU) and
elastic restore, reduced qwen1.5-0.5b.

On 2x2, with and without microbatches, 2 steps match the reference's
single-device ``make_train_step`` (losses within 1e-3, params within
rtol = atol = 2e-3).  The 2x2 state is then written by rank 0 as one
logical checkpoint (``statesharding.gather_state``), restored on a 1x4
mesh of the same ranks (its attention then runs replicated: 2 kv heads)
and on one device in this process; each next step agrees with the
reference's single-device step from that checkpoint within 2e-3.

The ranks are spawned once for the module; no rank process imports JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_train as H  # noqa: E402


def _rank(mesh, jobs):
    return H.train_jobs(mesh, jobs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("elastic"))
    jcfg = H.ref_cfg()
    state = H.ref_init(jcfg)
    bs = H.batches(jcfg.vocab_size, n=H.STEPS + 1)
    cfg = H.port_cfg()
    jobs = [dict(name="2x2", shape=(2, 2), cfg=cfg, state=state, batches=bs,
                 save=(ck, H.STEPS)),
            dict(name="2x2_mb", shape=(2, 2), cfg=cfg, state=state,
                 batches=bs, microbatch=4),
            dict(name="1x4", shape=(1, 4), cfg=cfg, state=state,
                 batches=bs[H.STEPS:], steps=1, restore=(ck, H.STEPS))]
    res, ref = H.with_ranks(_rank, 2, jobs, lambda: {
        "2x2": H.ref_steps(jcfg, state, bs[:H.STEPS]),
        "2x2_mb": H.ref_steps(jcfg, state, bs[:H.STEPS], microbatch=4)},
        n_data=2)
    return res, ref, ck, jcfg, state, bs


@pytest.mark.parametrize("name", ["2x2", "2x2_mb"])
def test_2x2_matches_single_device(runs, name):
    res, ref = runs[:2]
    assert H.check_against_ref(ref[name], res[name], name) is None
    assert res[name]["agree"]


@pytest.fixture(scope="module")
def restored(runs):
    """The checkpoint as the reference's state (numpy), and the
    reference's next step from it."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.models import train_state_from_jax
    _, _, ck, jcfg, state, bs = runs
    like = train_state_from_jax(state, "cpu")
    st = H.np_tree(restore_checkpoint(ck, H.STEPS, like))
    return st, H.ref_steps(jcfg, st, bs[H.STEPS:])


def test_checkpoint_holds_the_2x2_state(runs, restored):
    st, _ = restored
    for a, b in zip(H.leaves(runs[0]["2x2"]["state"]), H.leaves(st)):
        np.testing.assert_array_equal(a, b)


def test_restore_on_1x4(runs, restored):
    r = runs[0]["1x4"]
    assert H.check_against_ref(restored[1], r, "1x4") is None
    assert r["agree"]


def test_restore_on_one_device(runs, restored):
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.models import train_state_from_jax
    from repro_torch.train import make_train_step
    _, _, ck, _, state, bs = runs
    st = restore_checkpoint(ck, H.STEPS, train_state_from_jax(state, "cpu"))
    st, m = make_train_step(H.port_cfg(), warmup=H.WARMUP,
                            total_steps=H.TOTAL)(st, bs[H.STEPS])
    res = {"losses": [float(m["loss"])], "state": H.np_tree(st)}
    assert H.check_against_ref(restored[1], res, "one device") is None
