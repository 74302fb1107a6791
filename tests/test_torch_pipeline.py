"""The GPipe schedule (``parallel.pipeline.pipeline_apply``) on 4 ranks
(gloo, the CPU) at the reference's test shape: S = 4 stages, M = 8
microbatches of 2 rows, d = 16, ``tanh(h @ W_s)`` per stage.  Its output
and its gradients with respect to the stacked stage weights and the
input agree with the reference's sequential stage loop (JAX) within
1e-5.

Also the train CLI's ``--devices``: the reference's mesh choice is
printed, the losses match the one-device CLI within 1e-3 (with
``--grad-compress`` too), and a run checkpointed on 2 ranks resumes on
4 (the checkpoint holds the logical state).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

S_STAGES, M, MB, D = 4, 8, 2, 16
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    rng = np.random.default_rng(3)
    ws = (rng.normal(size=(S_STAGES, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.normal(size=(M, MB, D)).astype(np.float32)
    cot = rng.normal(size=(M, MB, D)).astype(np.float32)
    return ws, x, cot


def _stage(w, h):
    return torch.tanh(h @ w)


def _rank(mesh):
    from repro_torch.parallel.pipeline import pipeline_apply
    ws, x, cot = (torch.from_numpy(a) for a in _inputs())
    ws.requires_grad_(True)
    x.requires_grad_(True)
    out = pipeline_apply(_stage, mesh, "model", ws, x)
    (out * cot).sum().backward()
    # each stage holds its own row of the gradient; the input's is stage
    # 0's: both summed over the stages
    gw = mesh.all_reduce_sum(ws.grad.clone())
    gx = mesh.all_reduce_sum(torch.zeros_like(x) if x.grad is None
                             else x.grad.clone())
    with torch.no_grad():
        fwd = pipeline_apply(_stage, mesh, "model", ws, x)
    return {"out": out.detach().numpy(), "gw": gw.numpy(), "gx": gx.numpy(),
            "agree": mesh.agree(out.detach().numpy()),
            "no_grad": fwd.numpy()}


@pytest.fixture(scope="module")
def runs():
    from repro_torch.parallel.mesh import run_ranks
    return run_ranks(_rank, 4, timeout=300)


@pytest.fixture(scope="module")
def reference():
    import jax
    import jax.numpy as jnp
    ws, x, cot = _inputs()

    def seq(ws, x):
        h = x
        for s in range(S_STAGES):
            h = jnp.tanh(h @ ws[s])
        return h
    out = seq(jnp.asarray(ws), jnp.asarray(x))
    gw, gx = jax.grad(lambda w, h: jnp.sum(seq(w, h) * cot),
                      argnums=(0, 1))(jnp.asarray(ws), jnp.asarray(x))
    return np.asarray(out), np.asarray(gw), np.asarray(gx)


def test_pipeline_output(runs, reference):
    np.testing.assert_allclose(runs["out"], reference[0], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(runs["no_grad"], runs["out"])
    assert runs["agree"]


def test_pipeline_gradients(runs, reference):
    np.testing.assert_allclose(runs["gw"], reference[1], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(runs["gx"], reference[2], rtol=1e-5,
                               atol=1e-5)


# --- the train CLI's --devices ----------------------------------------------

def _cli(args):
    """The CLI started with ``args``; ``_out`` waits for its output."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--batch", "4", "--seq", "16"] + args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)


def _out(p):
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err[-3000:]
    return out


def _losses(out):
    return {int(ln.split()[1]): float(ln.split()[3])
            for ln in out.splitlines() if ln.startswith("step ")}


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    args = ["--steps", "4", "--ckpt-every", "2"]
    runs = {"one": _cli(args + ["--ckpt-dir", str(d / "one")]),
            "2": _cli(args + ["--devices", "2", "--ckpt-dir", str(d / "2")]),
            "4gc": _cli(args + ["--devices", "4", "--grad-compress",
                                "--ckpt-dir", str(d / "4gc")])}
    out = {k: _out(p) for k, p in runs.items()}      # the three at once
    # the 2-rank run's step 4 removed: the same command on 4 ranks
    # resumes from its step-2 checkpoint
    import shutil
    shutil.rmtree(d / "2" / "step_00000004")
    out["resume4"] = _out(_cli(args + ["--devices", "4", "--ckpt-dir",
                                       str(d / "2")]))
    return out


@pytest.mark.parametrize("name, mesh", [("2", "{'data': 1, 'model': 2}"),
                                        ("4gc", "{'data': 1, 'model': 4}")])
def test_cli_devices(cli, name, mesh):
    out = cli[name]
    assert f"mesh: {mesh}" in out and out.count("done") == 1
    one, got = _losses(cli["one"]), _losses(out)
    assert sorted(got) == sorted(one) == [0, 3]
    for k in one:
        assert abs(one[k] - got[k]) <= 1e-3, (k, one[k], got[k])


def test_cli_resumes_on_another_mesh(cli):
    out = cli["resume4"]
    assert "resuming from step 2" in out
    assert abs(_losses(out)[3] - _losses(cli["2"])[3]) <= 1e-3
