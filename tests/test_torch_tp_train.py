"""Tensor-parallel training of reduced qwen1.5-0.5b on 2 ranks (gloo, the
CPU): a 1x2 mesh in the fp, int8 and exact-encoded MAC modes (fp with
microbatches too), against the reference's single-device
``make_train_step`` (2 steps: losses within 1e-3, params within rtol =
atol = 2e-3).  Where an int8 or encoded run parts from the reference, the
parting must start at an int8 activation code within 1e-3 of a .5
boundary (the row shards' partial sums add in another f32 order).  Also
the autograd rules of the model axis's collectives and the vocab-parallel
loss against the loss of the gathered logits.

The ranks are spawned once for the module; no rank process imports JAX.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_train as H  # noqa: E402

JOBS = {"tp2": dict(mode="fp"), "tp2_mb": dict(mode="fp", microbatch=4),
        "tp2_int8": dict(mode="int8", record=True),
        "tp2_encoded": dict(mode="encoded", record=True)}


def _rules(mesh):
    """Gradients through the model axis's collectives and the
    vocab-parallel loss on this rank."""
    from repro_torch.parallel.mesh import (copy_to_model, gather_from_model,
                                           reduce_from_model, set_mesh)
    from repro_torch.train.losses import lm_loss, lm_loss_vocab_parallel
    r = mesh.model_rank
    out = {}
    with set_mesh(mesh):
        x = torch.arange(4.0, requires_grad=True)
        (copy_to_model(x) * (r + 1)).sum().backward()
        out["copy"] = x.grad.tolist()
        y = torch.full((4,), float(r + 1), requires_grad=True)
        z = reduce_from_model(y)
        (z * torch.arange(4.0)).sum().backward()
        out["reduce"] = (z.tolist(), y.grad.tolist())
        c = torch.full((2, 3), float(r), requires_grad=True)
        full = gather_from_model(c)
        (full * torch.arange(6.0)).sum().backward()
        out["gather"] = (full.tolist(), c.grad.tolist())
        g = torch.Generator().manual_seed(0)
        logits = torch.randn((2, 5, 8), generator=g)
        labels = torch.randint(0, 8, (2, 5), generator=g)
        mine = logits[..., 4 * r:4 * r + 4].clone().requires_grad_(True)
        loss = lm_loss_vocab_parallel(mine, labels)
        loss.backward()
        whole = logits.clone().requires_grad_(True)
        ref = lm_loss(whole, labels)
        ref.backward()
        out["vp"] = (loss.item(), ref.item(),
                     (mine.grad - whole.grad[..., 4 * r:4 * r + 4]
                      ).abs().max().item())
    return out


def _backward_elsewhere(mesh):
    """A remat forward under the mesh whose backward runs on another
    thread, where no mesh is set (the autograd engine's device thread on
    the card): the recomputed blocks re-enter the forward's mesh, so the
    gradients equal those of a backward on this thread."""
    import threading
    from repro_torch.models import (apply_model, init_model, stack_layers,
                                    unstack_layers)
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.statesharding import shard_state
    from repro_torch.tree import tree_leaves
    cfg = H.port_cfg(remat=True)
    tokens = torch.as_tensor(H.batches(cfg.vocab_size, 1)[0]["tokens"])
    grads = []
    for elsewhere in (False, True):
        p = stack_layers(init_model(cfg, seed=0, device="cpu"), cfg)
        p = shard_state({"params": p, "opt": {"m": p}, "step":
                         torch.zeros(())}, cfg, mesh)["params"]
        leaves = tree_leaves(p)
        for x in leaves:
            x.requires_grad_(True)
        with torch.enable_grad(), set_mesh(mesh):
            logits, _ = apply_model(unstack_layers(p), cfg, tokens)
            loss = logits.float().square().mean()
        if elsewhere:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        else:
            loss.backward()
        grads.append([x.grad.clone() for x in leaves])
    return all(torch.equal(a, b) for a, b in zip(*grads))


def _rank(mesh, jobs):
    out = H.train_jobs(mesh, jobs)
    out["rules"] = _rules(mesh)
    out["elsewhere"] = _backward_elsewhere(mesh)
    return out


def _cfgs(mode):
    """(reference cfg, port cfg) of a MAC mode; the exact encoding's
    circuit in both packages."""
    if mode != "encoded":
        return H.ref_cfg(mode=mode), H.port_cfg(mode=mode)
    from repro.core.circuits import exact_product_circuit
    from repro.core.encoding import EncodingSpec
    from repro.core.mac import EncodedMac as JEnc
    from repro_torch.core.circuits import Circuit
    from repro_torch.core.encoding import EncodingSpec as TSpec
    from repro_torch.core.mac import EncodedMac as TEnc
    circ, s = exact_product_circuit(8, 8)
    jm = JEnc.from_spec(EncodingSpec(circ, s, 0.0))
    tm = TEnc.from_spec(TSpec(Circuit.from_json(jm.spec.circuit.to_json()),
                              np.asarray(jm.spec.s, np.float32), 0.0))
    return H.ref_cfg(mode=mode, mac=jm), H.port_cfg(mode=mode, mac=tm)


@pytest.fixture(scope="module")
def runs():
    bs = H.batches(H.ref_cfg().vocab_size)
    cfgs = {name: _cfgs(kw["mode"]) for name, kw in JOBS.items()}
    states = {name: H.ref_init(cfgs[name][0]) for name in JOBS}
    jobs = [dict(name=name, shape=(1, 2), state=states[name], batches=bs,
                 cfg=cfgs[name][1], microbatch=kw.get("microbatch"),
                 record=kw.get("record", False))
            for name, kw in JOBS.items()]

    def ref():
        return {name: H.ref_steps(cfgs[name][0], states[name], bs,
                                  microbatch=kw.get("microbatch"))
                for name, kw in JOBS.items()}
    res, refs = H.with_ranks(_rank, 2, jobs, ref)
    return res, refs, cfgs, bs


@pytest.mark.parametrize("name", sorted(JOBS))
def test_tp_matches_single_device(runs, name):
    res, ref, cfgs, bs = runs
    r = res[name]
    rec = JOBS[name].get("record")
    flip = H.check_against_ref(ref[name], r, name,
                               jcfg=cfgs[name][0] if rec else None,
                               batches=bs)
    print(f"{name}: losses ref {[m['loss'] for m in ref[name][0]]} port "
          f"{r['losses']}; first code apart where they part: {flip}")
    assert r["agree"]
    if flip is None:
        np.testing.assert_allclose(r["gnorms"],
                                   [m["gnorm"] for m in ref[name][0]],
                                   rtol=1e-3)


def test_autograd_rules(runs):
    """The sum's gradient over the model axis (copy), the identity (a
    reduce), this rank's columns (a gather); rank 0's view."""
    r = runs[0]["rules"]
    assert r["copy"] == [3.0] * 4                      # 1 + 2
    assert r["reduce"] == ([3.0] * 4, [0.0, 1.0, 2.0, 3.0])
    full, grad = r["gather"]
    assert full == [[0.0] * 3 + [1.0] * 3] * 2
    assert grad == [[0.0, 1.0, 2.0]] * 2


def test_remat_backward_on_another_thread(runs):
    assert runs[0]["elsewhere"]


def test_vocab_parallel_loss(runs):
    loss, ref, gdiff = runs[0]["rules"]["vp"]
    assert abs(loss - ref) <= 1e-6 * abs(ref)
    assert gdiff <= 1e-7
