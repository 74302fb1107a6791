"""Port parity for step checkpoints, the data pipeline and the train CLI
(``repro_torch.ckpt``, ``repro_torch.data.pipeline``,
``repro_torch.launch.train``) on the CPU: the reference's on-disk format
in both directions (a reference checkpoint continues training in the
port within the train-step tolerances of ``test_torch_train.py``; a port
checkpoint restores in the reference bit for bit), the commit protocol,
async saves, prefetch order and straggler skips, and the CLI's resume and
SIGTERM emergency checkpoint."""
import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as JK  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data.pipeline import DataPipeline as JPipe  # noqa: E402
from repro.train import init_train_state as j_init_state  # noqa: E402
from repro.train import make_train_step as j_make_step  # noqa: E402

from repro_torch import ckpt as TK  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.data import SyntheticLMDataset  # noqa: E402
from repro_torch.data.pipeline import DataPipeline as TPipe  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs():
    jc = dataclasses.replace(jget("qwen1.5-0.5b").reduced(), d_model=64,
                             d_ff=128, vocab_size=128)
    tc = dataclasses.replace(tget("qwen1.5-0.5b").reduced(), d_model=64,
                             d_ff=128, vocab_size=128)
    return jc, tc


def _batch(vocab, i):
    return SyntheticLMDataset(vocab, 16, seed=3).batch(i, 2)


def test_round_trip_bit_exact(tmp_path):
    _, tc = _cfgs()
    st = init_train_state(tc, seed=0, device="cpu")
    st, _ = make_train_step(tc)(st, _batch(tc.vocab_size, 0))
    d = TK.save_checkpoint(str(tmp_path), 1, st)
    assert sorted(os.listdir(d)) == ["DONE", "leaves.npz", "treedef.json"]
    back = TK.restore_checkpoint(str(tmp_path), 1,
                                 init_train_state(tc, seed=5, device="cpu"))
    for a, b in zip(tree_leaves(st), tree_leaves(back)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_reference_checkpoint_continues_in_port(tmp_path):
    """The reference trains 2 steps and saves; the port restores into its
    own state and takes step 3, which equals the reference's step 3."""
    jc, tc = _cfgs()
    js = j_init_state(jax.random.PRNGKey(0), jc)
    jstep = jax.jit(j_make_step(jc, warmup=1, total_steps=10))
    for i in range(2):
        js, _ = jstep(js, {k: jnp.asarray(v)
                           for k, v in _batch(jc.vocab_size, i).items()})
    JK.save_checkpoint(str(tmp_path), 2, jax.device_get(js))
    assert TK.latest_step(str(tmp_path)) == 2
    ts = TK.restore_checkpoint(str(tmp_path), 2,
                               init_train_state(tc, seed=9, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert int(ts["step"]) == 2 and int(ts["opt"]["t"]) == 2
    b = _batch(jc.vocab_size, 2)
    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = make_train_step(tc, warmup=1, total_steps=10)(ts, b)
    for k in ("loss", "gnorm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    for a, c in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=5e-4,
                                   atol=5e-5)


def test_port_checkpoint_restores_in_reference(tmp_path):
    jc, tc = _cfgs()
    ts = init_train_state(tc, seed=1, device="cpu")
    ts, _ = make_train_step(tc)(ts, _batch(tc.vocab_size, 0))
    TK.save_checkpoint(str(tmp_path), 1, ts)
    assert JK.latest_step(str(tmp_path)) == 1
    like = j_init_state(jax.random.PRNGKey(0), jc)
    js = JK.restore_checkpoint(str(tmp_path), 1, like)
    assert jax.tree_util.tree_structure(js) == \
        jax.tree_util.tree_structure(like)
    for a, b in zip(jax.tree_util.tree_leaves(js), tree_leaves(ts)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # and the reference trains on from it
    js, m = jax.jit(j_make_step(jc))(js, {k: jnp.asarray(v) for k, v in
                                          _batch(jc.vocab_size, 1).items()})
    assert np.isfinite(float(m["loss"]))


def test_incomplete_checkpoint_ignored(tmp_path):
    _, tc = _cfgs()
    st = init_train_state(tc, seed=0, device="cpu")
    TK.save_checkpoint(str(tmp_path), 3, st)
    os.makedirs(tmp_path / "step_00000007.tmp")           # torn write
    os.makedirs(tmp_path / "step_00000009")               # no DONE
    assert TK.latest_step(str(tmp_path)) == 3
    assert JK.latest_step(str(tmp_path)) == 3
    assert TK.latest_step(str(tmp_path / "missing")) is None


def test_async_save_and_overwrite(tmp_path):
    _, tc = _cfgs()
    st = init_train_state(tc, seed=0, device="cpu")
    t = TK.async_save_checkpoint(str(tmp_path), 4, st)
    # the snapshot is taken at once: a later state does not leak in
    st2, _ = make_train_step(tc)(st, _batch(tc.vocab_size, 0))
    t.join(timeout=60)
    assert not t.is_alive()
    back = TK.restore_checkpoint(str(tmp_path), 4, st2)
    for a, b in zip(tree_leaves(st), tree_leaves(back)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    t = TK.async_save_checkpoint(str(tmp_path), 4, st2)     # overwrite
    t.join(timeout=60)
    assert not t.is_alive()
    back = TK.restore_checkpoint(str(tmp_path), 4, st)
    for a, b in zip(tree_leaves(st2), tree_leaves(back)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004"]


def _within(seconds, fn):
    """Run ``fn`` in a daemon thread; fail if it is not done in
    ``seconds`` (the pipelines block on queues), re-raise its error."""
    box = {}

    def run():
        try:
            fn()
        except BaseException as e:     # handed to the test thread below
            box["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=seconds)
    assert not t.is_alive(), f"did not finish within {seconds}s"
    if "error" in box:
        raise box["error"]


def test_pipeline_prefetch_order():
    _within(60, _prefetch_order)


def _prefetch_order():
    """Both pipelines hand out the same (step, batch) sequence from a
    start step."""
    ds = SyntheticLMDataset(64, 8, seed=2)
    tp = TPipe(lambda s: ds.batch(s, 2), start_step=5, prefetch=2)
    jp = JPipe(lambda s: ds.batch(s, 2), start_step=5, prefetch=2)
    try:
        for _ in range(4):
            (ts, tb), (js, jb) = tp.next(), jp.next()
            assert ts == js
            np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    finally:
        tp.stop()
        jp.stop()
    assert not tp._thread.is_alive()


def test_pipeline_straggler_skip():
    _within(60, _straggler_skip)


def _straggler_skip():
    """A batch later than ``skip_threshold`` is skipped and logged, as in
    the reference."""
    def make(slow):
        def f(s):
            if s == 1:
                slow.wait(timeout=5)
            return {"s": s}
        return f
    out = {}
    for name, cls in (("port", TPipe), ("ref", JPipe)):
        slow = threading.Event()
        p = cls(make(slow), prefetch=1, skip_threshold=0.2)
        try:
            got = [p.next()[0]]
            t0 = time.monotonic()
            timer = threading.Timer(0.5, slow.set)
            timer.start()
            got.append(p.next()[0])
            timer.join()
            out[name] = (got, list(p.skipped), time.monotonic() - t0 < 5)
        finally:
            p.stop()
    assert out["port"] == out["ref"]
    # one skip logged (the reference logs its own step counter, which
    # only skips advance), and the late batch still arrives
    assert len(out["port"][1]) == 1 and out["port"][0] == [0, 1]


def _cli(args, **kw):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--reduced",
         "--device", "cpu", "--batch", "2", "--seq", "16"] + args,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT, **kw)


def test_cli_writes_and_resumes(tmp_path):
    d = str(tmp_path / "ck")
    p = _cli(["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", d])
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err
    assert "step 0 loss" in out and "step 3 loss" in out
    assert TK.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]
    p = _cli(["--steps", "6", "--ckpt-every", "2", "--ckpt-dir", d,
              "--mac-mode", "int8"])
    out, err = p.communicate(timeout=300)
    assert p.returncode != 0          # an fp checkpoint lacks int8 leaves
    p = _cli(["--steps", "6", "--ckpt-every", "2", "--ckpt-dir", d])
    out, err = p.communicate(timeout=300)
    assert p.returncode == 0, err
    assert "resuming from step 4" in out and "step 5 loss" in out
    assert "step 0 loss" not in out
    assert TK.latest_step(d) == 6


def test_cli_sigterm_emergency_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    p = _cli(["--steps", "100000", "--ckpt-every", "100000", "--ckpt-dir",
              d])
    try:
        for line in p.stdout:                  # wait for the first step
            if line.startswith("step 0 loss"):
                break
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=120)
    finally:
        p.kill()
    assert p.returncode == 0, err
    assert "emergency checkpoint" in out
    step = TK.latest_step(d)
    assert step is not None and step >= 1
    assert os.path.exists(os.path.join(d, f"step_{step:08d}", "DONE"))


@pytest.mark.parametrize("flag", [["--devices", "8", "--arch", "xlstm-1.3b"],
                                  ["--devices", "2", "--grad-compress",
                                   "--arch", "deepseek-v3-671b"]])
def test_cli_rejects_mesh_options(flag, tmp_path):
    """``--devices`` trains the dense archs and qwen3-moe on several ranks
    (``tests/test_torch_pipeline.py`` runs it); the other families are
    refused before any rank starts, naming the ROADMAP item."""
    p = _cli(["--steps", "1", "--ckpt-dir", str(tmp_path)] + flag)
    out, err = p.communicate(timeout=120)
    assert p.returncode == 2
    assert "Queue A, item 3" in err
