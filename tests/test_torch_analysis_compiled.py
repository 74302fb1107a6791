"""The port's captured-step audit (``repro_torch.analysis.compiled``) on
the CPU: the smoke traces' capture counts are exact on the eager steps'
counter, pools are updated in place, no weight-sized tensor is made by a
step, and at TP 2 over two gloo ranks a decode step and a prefill chunk
make exactly the pinned collectives (a single-rank step none).  Case
names follow ``tests/test_analysis.py``'s compiled-audit cases."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


@pytest.fixture(scope="module")
def model():
    from repro_torch.analysis.compiled import reduced_model
    return reduced_model("cpu")


def test_recompile_counts_are_exact(model):
    """Both smoke traces (plain and speculative) land on the pinned
    counts, evict, and record no weight-sized allocation."""
    from repro_torch.analysis.compiled import (EXPECTED_CAPTURES,
                                               audit_engine_trace)
    params, cfg = model
    f, rep = audit_engine_trace(params, cfg)
    assert [str(x) for x in f] == []
    for mode in ("plain", "spec"):
        assert rep[mode]["captures"] == EXPECTED_CAPTURES[mode]
        assert rep[mode]["evictions"] >= 1
        assert rep[mode]["ops_recorded"] > 0
    assert rep["spec"]["spec_rounds"] > 0


def test_recompile_count_catches_a_second_capture(model):
    from repro_torch.analysis.compiled import (RULE_RECOMPILE,
                                               check_capture_counts,
                                               run_smoke_trace, step_counts)
    params, cfg = model
    eng, counts, st = run_smoke_trace(params, cfg)
    eng.steps["decode"].binds += 1          # as a step bound (captured) again
    f = check_capture_counts(step_counts(eng), st, "plain")
    assert any(x.rule == RULE_RECOMPILE and "captured 2x" in x.message
               for x in f)


def test_donation_clean_and_pool_copy_caught(model):
    from repro_torch.analysis.compiled import (check_donation,
                                               run_smoke_trace,
                                               smoke_prompts)
    from repro_torch.analysis.selftest import _pool_copied
    params, cfg = model
    eng, _, _ = run_smoke_trace(params, cfg)

    def more():
        eng.submit(smoke_prompts(cfg.vocab_size)[2], max_new=5)
        eng.run()
    assert check_donation(eng, more) == []
    assert _pool_copied()


def test_compiled_audit_catches_a_weight_copy():
    """A step that copies a 2 MB weight, or casts a bf16 one to f32, makes
    a weight-sized tensor; one that reads it through a view does not, nor
    does an activation of a weight's element count."""
    from repro_torch.analysis.compiled import (RULE_CAPTURE, AllocRecorder,
                                               check_capture)
    params = {"layers": [{"mlp": {"wi": torch.randn(512, 1024),
                                  "wo": torch.randn(1024, 512)
                                  .to(torch.bfloat16)}}]}
    w = params["layers"][0]["mlp"]["wi"]
    x = torch.randn(4, 512)
    with AllocRecorder() as clean:
        x @ w.t().t()
        torch.randn(512, 1024) * 2.0
    with AllocRecorder() as dirty:
        x @ w.clone()
    with AllocRecorder() as cast:
        params["layers"][0]["mlp"]["wo"].float()
    assert check_capture(clean.records, params, "clean") == []
    f = check_capture(dirty.records, params, "dirty")
    assert any(x.rule == RULE_CAPTURE and "layers/0/mlp/wi" in x.message
               for x in f)
    f = check_capture(cast.records, params, "cast")
    assert any(x.rule == RULE_CAPTURE and "layers/0/mlp/wo" in x.message
               for x in f)


def test_weight_cast_in_step_is_caught():
    """A step of an engine that casts its bf16 embedding to f32 is caught
    by element count (the bytes differ)."""
    from repro_torch.analysis.selftest import _weight_cast_in_step
    assert _weight_cast_in_step()


def test_graph_pool_gate():
    """The graph pools' bytes pass at the margin a graph and fail past
    it."""
    from repro_torch.analysis.compiled import (GRAPH_POOL_MARGIN,
                                               RULE_CAPTURE,
                                               check_graph_pools)
    assert check_graph_pools(2 * GRAPH_POOL_MARGIN, 2, 1 << 22, "ok") == []
    f = check_graph_pools(2 * GRAPH_POOL_MARGIN + 1, 2, 1 << 22, "over")
    assert [x.rule for x in f] == [RULE_CAPTURE]


def test_stray_all_gather_is_caught():
    from repro_torch.analysis.selftest import _stray_all_gather
    assert _stray_all_gather()


def test_compiled_runner_cpu_rules(tmp_path):
    """``python -m repro_torch.analysis --compiled`` exits 0 on the tree:
    capture counts, purity and donation on reduced qwen, and the TP 2
    collective table over two gloo ranks (a single-rank step none)."""
    from repro_torch.analysis.compiled import EXPECTED_COLLECTIVES
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                        "--compiled", "--json", str(out)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    rep = json.loads(out.read_text())
    assert rep["findings"] == []
    col = rep["coverage"]["compiled"]["collectives"]
    assert col["steps"] == EXPECTED_COLLECTIVES
    assert col["single_rank"] == {}
    assert min(col["n_steps"].values()) >= 1


def test_mesh_counts_collectives_by_op():
    """``Mesh.by_op`` adds the op to the count it keeps; ``counters()``
    keeps its three totals (checked without a process group: a 1-rank
    gloo world)."""
    import torch.distributed as dist
    from repro_torch.parallel.mesh import Mesh, _free_port
    if dist.is_initialized():
        pytest.skip("a process group is already initialized")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        m = Mesh(1, 1)
        m.all_reduce_sum(torch.ones(3))            # an axis of 1: free
        assert m.counters() == (0, 0.0, 0) and not m.by_op
        m.shape["model"] = 2                        # count as if split
        m._groups["model"] = None
        m.all_reduce_sum(torch.ones(3))
        m._reduce(torch.ones(2, 4), dist.ReduceOp.SUM, "model",
                  kind="all-gather")
        n, _, nbytes = m.counters()
        assert (n, nbytes) == (2, 12 + 32)
        assert dict(m.by_op) == {"all-reduce": 1, "all-gather": 1}
        assert m.op_shapes[("all-gather", (2, 4))] == 1
    finally:
        dist.destroy_process_group()
