"""Small conv-net image classifier — the Table-2 accuracy-mechanism vehicle
(port of ``repro/apps/image_cls.py``).

ResNet-style (3 conv layers + a dense head, NHWC), trained fp32 on the
synthetic shape dataset, then evaluated under:
  fp32 → int8-uniform (paper "Orig.") → encoded MAC ("Prop.")
  → fine-tuned position weights → 4-bit non-uniform variants.
Every conv and dense layer routes through ``core.layers`` (the MAC modes
of the LM stack).  The params are nested dicts of tensors with the
reference's names (``w``, ``s``, ``a_scale``); every function runs on the
params' device and draws its batches from numpy generators seeded as the
reference's, so the same initial params give the reference's batches.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.layers import (MacConfig, calibrate_dense, conv_apply,
                                     conv_init, conv_patches, dense_apply,
                                     dense_init)
from repro_torch.device import resolve_device
from repro_torch.models import to_device
from repro_torch.optim import make_optimizer
from repro_torch.quant.nonuniform import kmeans_levels, nonuniform_codes
from repro_torch.tree import tree_map, value_and_grad


def _device_of(params: dict) -> torch.device:
    return params["c1"]["w"].device


def cnn_init(generator: torch.Generator, device=None) -> dict:
    """The net's fp params (width 16, 10 classes), drawn on the host from
    ``generator`` (a CPU generator) and moved to ``device`` (default: the
    card)."""
    width, mcfg = 16, MacConfig()
    p = {
        "c1": conv_init(generator, 3, 3, 3, width, mcfg),
        "c2": conv_init(generator, 3, 3, width, width, mcfg),
        "c3": conv_init(generator, 3, 3, width, 2 * width, mcfg),
        "d1": dense_init(generator, 2 * width * 16, 64, mcfg),
        "d2": dense_init(generator, 64, 10, mcfg),
    }
    return to_device(p, resolve_device(device))


def params_from_jax(tree, device=None) -> dict:
    """The reference's CNN params (nested dicts of arrays, e.g. converted
    with ``numpy.asarray``) as the port's tree on ``device`` (default:
    the card); names and dtypes are the same in both packages."""
    return to_device(tree_map(lambda a: torch.from_numpy(np.array(a)), tree),
                     resolve_device(device))


def cnn_apply(p: dict, x: torch.Tensor, mcfg: MacConfig) -> torch.Tensor:
    h = F.relu(conv_apply(p["c1"], x, mcfg, 3, 3))
    h = F.relu(conv_apply(p["c2"], h, mcfg, 3, 3, stride=2))
    h2 = F.relu(conv_apply(p["c3"], h, mcfg, 3, 3, stride=2))
    h2 = h2.reshape(x.shape[0], -1)
    h3 = F.relu(dense_apply(p["d1"], h2, mcfg))
    return dense_apply(p["d2"], h3, mcfg)


def _xent(p, xb, yb, mcfg) -> torch.Tensor:
    lp = F.log_softmax(cnn_apply(p, xb, mcfg), dim=-1)
    return -lp.gather(1, yb[:, None]).mean()


def train_cnn(params: dict, imgs: np.ndarray, labels: np.ndarray,
              mcfg: MacConfig = MacConfig(), epochs: int = 8,
              losses=None) -> dict:
    """AdamW at lr 3e-3 from ``params`` (``cnn_init`` or
    ``params_from_jax``) on their device: each epoch a ``default_rng(0)``
    permutation, full batches of 64 only.  ``losses``, a list, receives
    each step's loss (a 0-d tensor on the device)."""
    dev = _device_of(params)
    opt = make_optimizer("adamw")
    state = opt.init(params)
    X = torch.from_numpy(imgs).to(dev)
    Y = torch.from_numpy(labels).to(dev).long()
    n, batch = imgs.shape[0], 64
    rng = np.random.default_rng(0)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            idx = torch.from_numpy(order[i:i + batch]).to(dev)
            xb, yb = X[idx], Y[idx]
            loss, g = value_and_grad(lambda p: _xent(p, xb, yb, mcfg), params)
            params, state = opt.update(g, state, params, 3e-3)
            if losses is not None:
                losses.append(loss.detach())
    return params


@torch.no_grad()
def predict(params: dict, imgs: np.ndarray, mcfg: MacConfig) -> np.ndarray:
    """Each image's arg-max class (the first on a tie), in batches of
    256."""
    dev = _device_of(params)
    out = []
    for i in range(0, imgs.shape[0], 256):
        x = torch.from_numpy(imgs[i:i + 256]).to(dev)
        out.append(cnn_apply(params, x, mcfg).argmax(-1).cpu().numpy())
    return np.concatenate(out)


def accuracy(params: dict, imgs: np.ndarray, labels: np.ndarray,
             mcfg: MacConfig) -> float:
    hits = int((predict(params, imgs, mcfg) == labels).sum())
    return hits / imgs.shape[0]


@torch.no_grad()
def calibrate(params: dict, imgs: np.ndarray, mcfg: MacConfig,
              n: int = 256) -> dict:
    """Set activation-scale buffers from a calibration batch, layer by
    layer through the mode's own forward."""
    x = torch.from_numpy(imgs[:n]).to(_device_of(params))
    p = dict(params)
    p["c1"] = _cal_conv(p["c1"], x, mcfg, 3, 3)
    h = F.relu(conv_apply(p["c1"], x, mcfg, 3, 3))
    p["c2"] = _cal_conv(p["c2"], h, mcfg, 3, 3)
    h = F.relu(conv_apply(p["c2"], h, mcfg, 3, 3, stride=2))
    p["c3"] = _cal_conv(p["c3"], h, mcfg, 3, 3)
    h2 = F.relu(conv_apply(p["c3"], h, mcfg, 3, 3, stride=2))
    h2 = h2.reshape(x.shape[0], -1)
    p["d1"] = calibrate_dense(p["d1"], h2, mcfg)
    h3 = F.relu(dense_apply(p["d1"], h2, mcfg))
    p["d2"] = calibrate_dense(p["d2"], h3, mcfg)
    return p


def _cal_conv(pc, x, mcfg, kh, kw):
    # stride-1 patches, as the reference's calibration takes them, also
    # for the layers that run at stride 2
    return calibrate_dense(pc, conv_patches(x, kh, kw), mcfg)


def convert_params(params_fp: dict, mcfg_to: MacConfig) -> dict:
    """fp params → params for the target MacConfig: the executor's suffix
    schema (``aux_init``) declares which leaves the mode needs."""
    out = {}
    for name, p in params_fp.items():
        dev = p["w"].device
        q = {"w": p["w"]}
        aux = mcfg_to.executor.aux_init("w", mcfg_to)
        if "w_s" in aux:
            q["s"] = aux["w_s"].to(dev)
        if "w_as" in aux:
            q["a_scale"] = p.get("a_scale", aux["w_as"].to(dev))
        out[name] = q
    return out


def finetune_s(params: dict, imgs: np.ndarray, labels: np.ndarray,
               mcfg: MacConfig, steps: int = 150) -> dict:
    """Paper §3.3: fine-tune ONLY the position weights (SGD with momentum
    at lr 1e-3, STE gradients); batches of 64 from ``default_rng(1)``."""
    dev = _device_of(params)
    opt = make_optimizer("sgd")
    s_tree = {k: v["s"] for k, v in params.items() if "s" in v}
    state = opt.init(s_tree)
    X = torch.from_numpy(imgs).to(dev)
    Y = torch.from_numpy(labels).to(dev).long()

    def loss_of(st, xb, yb):
        p = {k: dict(v, s=st[k]["s"]) if k in st else v
             for k, v in params.items()}
        return _xent(p, xb, yb, mcfg)

    rng = np.random.default_rng(1)
    n = imgs.shape[0]
    for _ in range(steps):
        idx = torch.from_numpy(rng.integers(0, n, 64)).to(dev)
        xb, yb = X[idx], Y[idx]
        _, g = value_and_grad(lambda st: loss_of(st, xb, yb),
                              {k: {"s": s} for k, s in s_tree.items()})
        s_tree, state = opt.update({k: v["s"] for k, v in g.items()},
                                   state, s_tree, 1e-3)
    return {k: dict(v, s=s_tree[k]) if k in s_tree else v
            for k, v in params.items()}


def nonuniform_to_int8_params(params: dict) -> dict:
    """The paper's non-uniform setting: per-layer 4-bit k-means levels in
    place of each weight.  As the reference's code, the weights are the
    levels themselves (``levels[codes]``): nothing snaps them to the
    int8 grid here, though the reference's docstring says so."""
    out = {}
    for name, p in params.items():
        w = p["w"]
        levels = kmeans_levels(w, bits=4)
        codes = nonuniform_codes(w, levels)
        out[name] = dict(p, w=levels[codes.long()])
    return out
