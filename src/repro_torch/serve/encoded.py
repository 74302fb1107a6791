"""Calibrated encoded-MAC serving: calibrate → fold → serve (port of
``repro/serve/encoded.py`` with given encodings; the per-family encoding
search and the artifact bundle cache wait — ROADMAP: encoded-serving
bundle cache and family search).

 1. **capture** — run the synthetic calibration stream through the fp
    model with a recorder hook in ``nn.common.linear`` and keep, per
    linear call site, the activation max-abs.  Sites are keyed by
    (layer index, sub-module, name) — attention ``wo`` and MLP ``wo``
    share a name, not a key — where the reference keys by a hash of the
    weight; both give the same per-layer ``amax``.
 2. **fold** — quantize each weight, fold circuit + position weights +
    weight bit-planes into a ``(U, k, n)`` tensor and a bias
    (``core.decompose.fold_weights``), layer by layer on the weights'
    device, straight to bf16 (an f32 fold of all 168 full-width linears
    would hold 9.9 GB), and graft ``name_fw/fb/as/ws`` leaves onto the
    params.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.circuits import exact_product_circuit
from repro_torch.core.encoding import EncodingSpec
from repro_torch.core.layers import MacConfig
from repro_torch.core.mac import EncodedMac
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import apply_model, to_device
from repro_torch.nn.common import activation_recorder
from repro_torch.quant.uniform import calibrate_scale, qmax, quantize_codes

FAMILIES = ("wq", "wk", "wv", "wo", "wi", "wg", "w")


def exact_encodings(bits: int = 8) -> dict:
    """The bit-exact AND-plane encoding for every projection family
    (``--encoding exact``): U = ``bits`` activation planes, RMSE 0."""
    circ, s = exact_product_circuit(bits, bits)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    return {n: mac for n in FAMILIES}


@dataclasses.dataclass
class CalibStats:
    """Per-call-site activation max-abs from the calibration stream."""
    amax: dict          # (layer | None, sub | None, name) -> float
    n_tokens: int = 0


def _linear_sites(params) -> dict:
    """{id(weight): (layer, sub, name)} for every linear weight."""
    sites = {}
    for li, layer in enumerate(params["layers"]):
        for sub in ("attn", "mlp"):
            for name, t in layer[sub].items():
                if name in FAMILIES and t.dim() == 2:
                    sites[id(t)] = (li, sub, name)
    if "lm_head" in params:
        sites[id(params["lm_head"]["w"])] = (None, "lm_head", "w")
    return sites


@torch.inference_mode()
def capture_activation_stats(params, cfg, *, n_batches: int = 4,
                             batch_size: int = 4, seq_len: int = 64,
                             seed: int = 0) -> CalibStats:
    """Run the calibration stream in fp mode on the params' device and
    record each linear call site's activation max-abs."""
    calib_cfg = dataclasses.replace(cfg, mac=MacConfig(mode="fp"))
    data = SyntheticLMDataset(cfg.vocab_size, seq_len, seed=seed)
    sites = _linear_sites(params)
    dev = params["embed"]["table"].device
    stats = CalibStats(amax={})

    def hook(name, w, x):
        key = sites[id(w)]
        a = float(x.detach().to(torch.float32).abs().max())
        stats.amax[key] = max(stats.amax.get(key, 0.0), a)

    with activation_recorder(hook):
        for step in range(n_batches):
            tokens = torch.from_numpy(data.batch(step, batch_size)["tokens"])
            apply_model(params, calib_cfg, tokens.to(dev))
            stats.n_tokens += int(tokens.numel())
    return stats


def _node(params, li, sub):
    return params[sub] if li is None else params["layers"][li][sub]


@torch.inference_mode()
def fold_linear_params(params, stats: CalibStats, macs: dict,
                       bits: int) -> dict:
    """Folded leaves per calibrated site: {(layer, sub): {name_fw (U,k,n)
    bf16, name_fb (n,) f32, name_as, name_ws (0-d f32)}}, on the weights'
    device, one linear at a time."""
    delta: dict = {}
    qm = np.float32(qmax(bits))
    for (li, sub, name), amax in stats.amax.items():
        if name not in macs:
            continue
        mac = macs[name]
        w = _node(params, li, sub)[name].to(torch.float32)
        sw = calibrate_scale(w, bits)
        wc = quantize_codes(w, sw, bits)
        s = torch.as_tensor(np.asarray(mac.spec.s, np.float32),
                            device=w.device)
        Wt, b = mac.program.fold_weights(wc, s)
        sa = np.maximum(np.float32(amax), np.float32(1e-8)) / qm
        delta.setdefault((li, sub), {}).update({
            name + "_fw": Wt.to(torch.bfloat16),
            name + "_fb": b,
            name + "_as": torch.tensor(sa, dtype=torch.float32,
                                       device=w.device),
            name + "_ws": sw.reshape(()),
        })
        del Wt, wc
    return delta


def prepare_encoded_serving(params, cfg, *, macs_override: Optional[dict]
                            = None, seed: int = 0, calib_batches: int = 4,
                            calib_batch_size: int = 4, calib_seq: int = 64,
                            verbose: bool = False, device=None):
    """fp params → encoded-serving params on ``device`` (default: the
    card; params elsewhere are moved there first).

    Returns ``(params_enc, cfg_enc, info)``: ``cfg_enc.mac`` is an
    'encoded_infer' MacConfig carrying the per-family encodings and
    ``params_enc`` additionally holds the folded leaves (the fp tensors are
    shared, not copied).  ``macs_override`` ({family: EncodedMac}, e.g.
    ``exact_encodings()``) is required: the per-family search is not
    ported yet."""
    if macs_override is None:
        raise NotImplementedError(
            "the per-family encoding search is not ported yet (ROADMAP: "
            "encoded-serving bundle cache and family search); pass "
            "macs_override, e.g. exact_encodings() for --encoding exact")
    params = to_device(params, resolve_device(device))
    bits = cfg.mac.bits
    stats = capture_activation_stats(
        params, cfg, n_batches=calib_batches, batch_size=calib_batch_size,
        seq_len=calib_seq, seed=seed)
    if not stats.amax:
        raise ValueError("calibration recorded no linear layers")
    macs = dict(macs_override)
    delta = fold_linear_params(params, stats, macs, bits)
    out = dict(params)
    out["layers"] = [dict(layer) for layer in params["layers"]]
    for (li, sub), leaves in delta.items():
        if li is None:
            out[sub] = dict(out[sub], **leaves)
        else:
            out["layers"][li][sub] = dict(out["layers"][li][sub], **leaves)
    cfg_enc = dataclasses.replace(
        cfg, mac=MacConfig(mode="encoded_infer", bits=bits, macs=macs))
    n_folded = sum(1 for leaves in delta.values()
                   for k in leaves if k.endswith("_fw"))
    info = {"n_folded": n_folded, "calib_tokens": stats.n_tokens,
            "families": {n: float(m.spec.rmse) for n, m in macs.items()}}
    if verbose:
        print(f"[encoded-serving] folded {n_folded} linears "
              f"({stats.n_tokens} calibration tokens)")
    return out, cfg_enc, info
