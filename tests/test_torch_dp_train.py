"""Data-parallel training of reduced qwen1.5-0.5b on 2 ranks (gloo, the
CPU): a 2x1 mesh, with and without microbatches, against the reference's
single-device ``make_train_step`` over the same initial state and
batches (2 steps: losses within 1e-3, params within rtol = atol = 2e-3,
the reference's mesh tolerances).  Also: the batch rows each data rank
takes, the mesh's coordinates and axis groups (a 2x1 and a 1x2 mesh over
one world), and serving's refusal of a data axis.

The ranks are spawned once for the module (``parallel.mesh.run_ranks``)
and run every job; no rank process imports JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import torch_mesh_train as H  # noqa: E402

JOBS = {"dp2": dict(shape=(2, 1)),
        "dp2_mb": dict(shape=(2, 1), microbatch=4)}


def _rank(mesh, jobs):
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.serve import Engine
    out = H.train_jobs(mesh, jobs)
    tp = Mesh(1, 2)                    # a second shape over the same world
    out["coords"] = [(m.data_rank, m.model_rank, m.group(ax)[1])
                     for m, ax in ((mesh, "data"), (tp, "model"))]
    x = torch.full((3,), float(mesh.rank + 1))
    out["sums"] = (mesh.all_reduce_sum(x.clone(), "data").tolist(),
                   tp.all_reduce_sum(x.clone()).tolist(),
                   mesh.all_reduce_sum(x.clone(), "model").tolist())
    try:
        Engine({}, H.port_cfg(), device="cpu", mesh=mesh)
        out["serve"] = None
    except NotImplementedError as e:
        out["serve"] = str(e)
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg = H.ref_cfg()
    state = H.ref_init(jcfg)
    bs = H.batches(jcfg.vocab_size)
    jobs = [dict(name=k, cfg=H.port_cfg(), state=state, batches=bs, **v)
            for k, v in JOBS.items()]
    return H.with_ranks(_rank, 1, jobs, lambda: {
        k: H.ref_steps(jcfg, state, bs, microbatch=v.get("microbatch"))
        for k, v in JOBS.items()}, n_data=2)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_dp_matches_single_device(runs, name):
    res, ref = runs
    r = res[name]
    assert H.check_against_ref(ref[name], r, name) is None
    np.testing.assert_allclose(r["gnorms"], [m["gnorm"] for m in
                                             ref[name][0]], rtol=1e-4)


@pytest.mark.parametrize("name", sorted(JOBS))
def test_ranks_agree_and_exchange_once(runs, name):
    r = runs[0][name]
    assert r["agree"]
    # a step's exchanges on a 2x1 mesh: the gradients' one all-reduce,
    # the loss's; no model axis
    n, nbytes = r["collectives"]
    assert n == 2 * H.STEPS
    n_params = sum(x.size for x in H.leaves(r["state"]["params"]))
    assert nbytes == H.STEPS * (4 * n_params + 4)


def test_mesh_axes(runs):
    """Rank 0 of a 2x1 and a 1x2 mesh over two ranks: its coordinates and
    the ranks of its axis groups; sums over each axis."""
    res = runs[0]
    assert res["coords"] == [(0, 0, [0, 1]), (0, 0, [0, 1])]
    data, model, none = res["sums"]
    assert data == [3.0] * 3 and model == [3.0] * 3 and none == [1.0] * 3


def test_serving_refuses_a_data_axis(runs):
    msg = runs[0]["serve"]
    assert msg is not None and "data axis" in msg and "ROADMAP" in msg


def test_data_rows_follow_the_reference_layout():
    """Rank d of D takes rows [d·B/D, (d+1)·B/D); with microbatches of
    mb, rows [i·mb + d·mb/D, i·mb + (d+1)·mb/D) of each chunk i."""
    from repro_torch.train.trainer import data_rows

    class M:
        n_data, data_rank = 2, 1
    assert data_rows(8, M) == ([4, 5, 6, 7], None)
    assert data_rows(8, M, 4) == ([2, 3, 6, 7], 2)
    assert data_rows(8, M, 8) == ([4, 5, 6, 7], None)
    with pytest.raises(ValueError):
        data_rows(8, M, 3)
