"""Calibrated encoded-MAC serving: the calibrate → search → fold → cache →
serve pipeline (port of ``repro/serve/encoded.py``).

 1. **capture** — run the synthetic calibration stream through the fp
    model with a recorder hook in ``nn.common.linear`` and keep, per
    linear call site, the activation max-abs and a value subsample of
    every call (``x.reshape(-1)[::stride]``, the reference's flattening
    order).  Sites are keyed by (layer index, sub-module path, name) —
    attention ``wo`` and MLP ``wo`` share a name, not a key; a shared
    expert's sub-module path is ``"moe/shared"`` — where the reference keys by
    a hash of the weight; both give the same per-layer statistics.  The
    router and the routed experts never pass through ``linear``, so they
    produce no record and stay fp, as in the reference.
 2. **search** — per projection family (the linear's param name) the
    paper's random search plus annealed refinement (``core.search``), with
    every least-squares fit weighted by the calibration stream's joint
    code distribution p(a)·p(b) (``family_row_weights``).
 3. **fold** — quantize each weight, fold its family's circuit + position
    weights + weight bit-planes into a ``(U, k, n)`` tensor and a bias
    (``core.decompose.fold_weights``), layer by layer on the weights'
    device, straight to bf16 (the kernel's operand type; the reference
    rounds its f32 fold to bf16 before every product), and graft
    ``name_fw/fb/as/ws`` leaves onto the params.
 4. **cache** — the encodings and folded leaves are a versioned bundle
    ``<cache_dir>/<arch>-<key>/``: ``enc_<family>.json``, ``folded.npz``
    (the reference's key paths, ``stack//attn//wq_fw`` …, stacked along L)
    and ``manifest.json``, written last.  The key is the reference's, so
    a bundle the reference built for the same params and options is a
    cache hit here.  The port stores folded ``*_fw`` leaves as bf16 bits
    (uint16, manifest ``"fw_dtype": "bfloat16"``); a reference bundle's
    f32 leaves are cast to bf16 on load.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import hashlib
import json
import os
import time
import zipfile
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import load_array_tree, save_array_tree
from repro_torch.core.circuits import exact_product_circuit
from repro_torch.core.encoding import EncodingSpec
from repro_torch.core.layers import MacConfig
from repro_torch.core.mac import EncodedMac, _ARTIFACT_DIR
from repro_torch.core.macexec import check_drafter
from repro_torch.core.search import anneal, random_search
from repro_torch.data.synthetic import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import (apply_model, to_device, to_reference_layout,
                                tree_from_reference)
from repro_torch.nn.common import activation_recorder
from repro_torch.parallel.sharding import linear_role
from repro_torch.quant.uniform import (calibrate_scale, code_histogram, qmax,
                                       quantize_codes)

ARTIFACT_VERSION = 1
DEFAULT_CACHE_DIR = os.path.join(_ARTIFACT_DIR, "serving")
FAMILIES = ("wq", "wk", "wv", "wo", "wi", "wg", "w")
# the projection families of an MLA arch (deepseek-v3): its attention's
# linears, the dense/shared-expert MLPs' and the head's
MLA_FAMILIES = ("wq_a", "wq_b", "wkv_a", "wkr", "wk_b", "wv_b", "wo",
                "wi", "wg", "w")
# the projection families of a hybrid arch (hymba): the attention's and
# MLP's, and the SSM's in-, B/C/dt- and out-projections (its conv, wdt,
# meta tokens and tied head stay fp)
HYBRID_FAMILIES = FAMILIES + ("win", "wbcdt", "wout")
# the projection families of an xlstm arch: the mLSTM's and sLSTM's in-
# and out-projections, the sLSTM FFN's up-projection and the untied head
# (the conv, the block-diagonal q/k/v, the gate projections and the
# sLSTM's recurrence are plain products and stay fp)
XLSTM_FAMILIES = ("wi", "wo", "wup", "w")
# errors that mark a bundle as unreadable (it is then rebuilt)
_BUNDLE_ERRORS = (OSError, ValueError, KeyError, json.JSONDecodeError,
                  zipfile.BadZipFile, EOFError)


def arch_families(cfg) -> tuple:
    """The projection families an arch's linears fall in."""
    if cfg.use_mla:
        return MLA_FAMILIES
    return {"hybrid": HYBRID_FAMILIES,
            "xlstm": XLSTM_FAMILIES}.get(cfg.family, FAMILIES)


def exact_encodings(bits: int = 8, families=FAMILIES) -> dict:
    """The bit-exact AND-plane encoding for every projection family in
    ``families`` (``--encoding exact``; ``arch_families(cfg)`` for an
    arch): U = ``bits`` activation planes, RMSE 0."""
    circ, s = exact_product_circuit(bits, bits)
    mac = EncodedMac.from_spec(EncodingSpec(circ, s, 0.0))
    return {n: mac for n in families}


# ---------------------------------------------------------------------------
# 1. capture
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CalibStats:
    """Per-call-site activation statistics from the calibration stream,
    keyed by (layer | None, sub-module path ("/"-joined), name)."""
    amax: dict          # site -> max |x| over the stream
    samples: dict       # site -> list of per-call f32 value subsamples
    n_tokens: int = 0


def _linear_sites(params) -> dict:
    """{id(weight): (layer, sub-module path, name)} for every 2-D weight
    of a layer (in any sub-module) and the untied head; only those a
    ``linear`` call reads get a record."""
    sites = {}

    def walk(node, li, path):
        for name, t in node.items():
            if isinstance(t, dict):
                walk(t, li, f"{path}/{name}" if path else name)
            elif isinstance(t, torch.Tensor) and t.dim() == 2:
                sites[id(t)] = (li, path, name)

    for li, layer in enumerate(params["layers"]):
        walk(layer, li, "")
    if "lm_head" in params:
        sites[id(params["lm_head"]["w"])] = (None, "lm_head", "w")
    return sites


def _site_order_of(params):
    """The reference's order of sites: the head first (its tree's
    ``lm_head`` precedes the stages), then each stage in run order (the
    dense prefix before the MoE stack) by sorted path, and the layers of
    a stacked leaf in turn."""
    def order(site):
        li, path, name = site
        if li is None:
            return (0, False, path, name, 0)
        return (1, "moe" in params["layers"][li], path, name, li)
    return order


@torch.inference_mode()
def capture_activation_stats(params, cfg, *, n_batches: int = 4,
                             batch_size: int = 4, seq_len: int = 64,
                             seed: int = 0,
                             max_samples_per_call: int = 2048
                             ) -> CalibStats:
    """Run the calibration stream in fp mode on the params' device and
    record each linear call site's activation max-abs and value
    subsample."""
    calib_cfg = dataclasses.replace(cfg, mac=MacConfig(mode="fp"))
    data = SyntheticLMDataset(cfg.vocab_size, seq_len, seed=seed)
    sites = _linear_sites(params)
    dev = params["embed"]["table"].device
    stats = CalibStats(amax={}, samples={})

    def hook(name, w, x):
        key = sites[id(w)]
        xf = x.detach().to(torch.float32).reshape(-1)
        stats.amax[key] = max(stats.amax.get(key, 0.0),
                              float(xf.abs().max()))
        stride = max(1, xf.numel() // max_samples_per_call)
        stats.samples.setdefault(key, []).append(xf[::stride].cpu().numpy())

    with activation_recorder(hook):
        for step in range(n_batches):
            tokens = torch.from_numpy(data.batch(step, batch_size)["tokens"])
            apply_model(params, calib_cfg, tokens.to(dev))
            stats.n_tokens += int(tokens.numel())
    return stats


def _node(params, li, path):
    node = params if li is None else params["layers"][li]
    for k in path.split("/"):
        node = node[k]
    return node


# ---------------------------------------------------------------------------
# 2. task-specific per-family search
# ---------------------------------------------------------------------------

@torch.inference_mode()
def family_row_weights(params, stats: CalibStats, bits: int,
                       blend: float = 0.5) -> dict:
    """Per-family (T,) f32 truth-table row weights from the calibration
    stream's joint code distribution p(a)·p(b), blended with uniform:
    ``blend·p(a)p(b)·T + (1 − blend)`` (mean ≈ 1).  Rows follow
    ``core.gates.operand_bit_table`` (a-major over raw two's-complement
    patterns).  Per layer: the weight's codes at its calibrated scale and
    the activation samples at ``max(amax, 1e-8) / qmax``, summed per
    family in the reference's order."""
    fam_a: dict = {}
    fam_w: dict = {}
    for key in sorted(stats.amax, key=_site_order_of(params)):
        li, path, name = key
        w = _node(params, li, path)[name].to(torch.float32)
        sw = float(calibrate_scale(w, bits))
        fam_w[name] = fam_w.get(name, 0.0) + code_histogram(w, sw, bits)
        sa = max(stats.amax[key], 1e-8) / qmax(bits)
        xs = np.concatenate(stats.samples[key])
        fam_a[name] = fam_a.get(name, 0.0) + code_histogram(xs, sa, bits)
    out = {}
    T = 1 << (2 * bits)
    for name in fam_a:
        pa = fam_a[name] / fam_a[name].sum()
        pb = fam_w[name] / fam_w[name].sum()
        emp = np.outer(pa, pb).reshape(-1)
        out[name] = (blend * emp * T + (1.0 - blend)).astype(np.float32)
    return out


def search_family_encodings(row_weights: dict, bits: int, m_bits,
                            n_samples: int = 128, refine: int = 64,
                            seed: int = 0, verbose: bool = False,
                            device=None,
                            timings: Optional[dict] = None) -> dict:
    """Random + anneal encoding search per projection family, the fits on
    ``device`` (default: the card).  Family i of the sorted names searches
    from seed ``seed + 101·i`` and anneals from ``+ 7919``.

    ``m_bits``: output width M — an int, or a {family: M} dict.
    ``timings``: if given, filled with each family's search seconds."""
    macs = {}
    for i, name in enumerate(sorted(row_weights)):
        t0 = time.perf_counter()
        mb = m_bits[name] if isinstance(m_bits, dict) else m_bits
        res = random_search(seed + 101 * i, mb, n_samples, bits, bits,
                            row_weights=row_weights[name],
                            patience=max(n_samples, 1), device=device)
        if refine:
            res = anneal(res.spec, seed + 101 * i + 7919, refine,
                         row_weights=row_weights[name], device=device)
        macs[name] = EncodedMac.from_spec(res.spec)
        dt = time.perf_counter() - t0
        if timings is not None:
            timings[name] = dt
        if verbose:
            print(f"  [{name}] M={mb} weighted-rmse={res.spec.rmse:.3f} "
                  f"U={macs[name].program.n_a_planes} ({dt:.2f}s)")
    return macs


# ---------------------------------------------------------------------------
# 3. fold
# ---------------------------------------------------------------------------

# the fold's f32 temporaries (the weight planes and W̃) are made for
# this many bytes of W̃ at a time: a full-width head (deepseek-v3's
# 7168 x 129280 at U = 8) would take 30 GB of each at once
_FOLD_BYTES = 1 << 31


def _fold_by_columns(program, wc, s):
    """``program.fold_weights`` of the codes ``wc (k, n)`` in column
    slices of at most ``_FOLD_BYTES`` of f32 W̃, each rounded to bf16 as it
    is made: (W̃ (U, k, n) bf16, bias (n,) f32).  A column of W̃ and of the
    bias depends on that column of the weight alone, so the slices give
    the one-pass fold's numbers."""
    k, n = wc.shape
    U = program.n_a_planes
    step = max(1, _FOLD_BYTES // (4 * U * k))
    if step >= n:
        Wt, b = program.fold_weights(wc, s)
        return Wt.to(torch.bfloat16), b
    Wt = torch.empty((U, k, n), dtype=torch.bfloat16, device=wc.device)
    b = torch.empty((n,), dtype=torch.float32, device=wc.device)
    for c0 in range(0, n, step):
        w_c, b_c = program.fold_weights(wc[:, c0:c0 + step], s)
        Wt[:, :, c0:c0 + step] = w_c
        b[c0:c0 + step] = b_c
        del w_c
    return Wt, b


@torch.inference_mode()
def fold_linear_params(params, stats: CalibStats, macs: dict,
                       bits: int) -> dict:
    """The folded-leaf delta in the port's layout (``{"layers": [{sub:
    {…}}, …], "lm_head": {…}}``, sub-modules nested as in the params):
    per calibrated site ``name_fw (U,k,n)``
    bf16, ``name_fb (n,)`` f32, ``name_as``, ``name_ws`` (0-d f32), each
    folded with its family's encoding, on the weights' device, one linear
    at a time."""
    delta: dict = {"layers": [{} for _ in params["layers"]]}
    qm = np.float32(qmax(bits))
    for (li, path, name), amax in stats.amax.items():
        if name not in macs:
            continue
        mac = macs[name]
        w = _node(params, li, path)[name].to(torch.float32)
        sw = calibrate_scale(w, bits)
        wc = quantize_codes(w, sw, bits)
        s = torch.as_tensor(np.asarray(mac.spec.s, np.float32),
                            device=w.device)
        Wt, b = _fold_by_columns(mac.program, wc, s)
        sa = np.maximum(np.float32(amax), np.float32(1e-8)) / qm
        node = delta if li is None else delta["layers"][li]
        for k in path.split("/"):
            node = node.setdefault(k, {})
        node.update({
            name + "_fw": Wt,
            name + "_fb": b,
            name + "_as": torch.tensor(sa, dtype=torch.float32,
                                       device=w.device),
            name + "_ws": sw.reshape(()),
        })
        del Wt, wc
    return delta


def _merge(params, delta):
    """params with the delta's leaves grafted on (the fp tensors are
    shared, not copied)."""
    if isinstance(params, list):
        return [_merge(p, d) for p, d in zip(params, delta)]
    out = dict(params)
    for k, v in delta.items():
        if isinstance(v, (dict, list)) and k in out:
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def _n_folded(delta) -> int:
    if isinstance(delta, list):
        return sum(map(_n_folded, delta))
    return sum(_n_folded(v) if isinstance(v, (dict, list))
               else k.endswith("_fw") for k, v in delta.items())


# ---------------------------------------------------------------------------
# 4. versioned artifact bundle
# ---------------------------------------------------------------------------

def _host(t) -> np.ndarray:
    """A tensor as a host numpy array; bf16 as its bits (uint16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


class _HostLayers(collections.abc.Sequence):
    """The per-layer tensors of one stacked leaf, copied to the host one
    at a time as ``save_array_tree`` writes them."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __len__(self):
        return len(self.tensors)

    def __getitem__(self, i):
        return _host(self.tensors[i])


def _leaves_in_reference_order(tree):
    """(leaf) of a reference-layout tree in ``jax.tree_util`` flatten
    order: sorted keys at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves_in_reference_order(v)
        else:
            yield v


def _params_fingerprint(params, cfg) -> str:
    """sha1 over every leaf's shape and bytes in the reference's leaf
    order, stacked leaves as ``(L, …)`` arrays (hashed layer by layer: the
    bytes of a C-order stack are its layers' bytes in turn).  The same
    params give the reference's fingerprint."""
    h = hashlib.sha1()
    for leaf in _leaves_in_reference_order(to_reference_layout(params,
                                                               cfg)):
        parts = leaf if isinstance(leaf, list) else [leaf]
        shape = tuple(parts[0].shape)
        if isinstance(leaf, list):
            shape = (len(parts),) + shape
        h.update(str(shape).encode())
        for p in parts:
            h.update(np.ascontiguousarray(_host(p)).tobytes())
    return h.hexdigest()


def _macs_fingerprint(macs: dict) -> str:
    h = hashlib.sha1()
    for name in sorted(macs):
        h.update(name.encode())
        h.update(macs[name].spec.circuit.to_json().encode())
        h.update(np.asarray(macs[name].spec.s, np.float32).tobytes())
    return h.hexdigest()


def _bundle_key(cfg, params, opts: dict) -> str:
    ident = dict(opts)
    ident.update(version=ARTIFACT_VERSION, arch=cfg.arch,
                 n_layers=cfg.n_layers, d_model=cfg.d_model,
                 params=_params_fingerprint(params, cfg))
    blob = json.dumps(ident, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def _host_tree(tree):
    """A reference-layout delta with host leaves: stacked leaves as
    ``_HostLayers`` (copied when written), the rest copied now."""
    return {k: _host_tree(v) if isinstance(v, dict)
            else _HostLayers(v) if isinstance(v, list) else _host(v)
            for k, v in tree.items()}


def _save_bundle(bundle: str, key: str, cfg, opts: dict, macs: dict,
                 delta: dict) -> int:
    """Write the bundle (encodings, folded leaves, then the manifest) and
    return its bytes."""
    os.makedirs(bundle, exist_ok=True)
    for name, mac in macs.items():
        EncodedMac.save(mac.spec, f"enc_{name}", artifact_dir=bundle)
    save_array_tree(os.path.join(bundle, "folded.npz"),
                    _host_tree(to_reference_layout(delta, cfg)))
    manifest = {
        "version": ARTIFACT_VERSION, "key": key, "arch": cfg.arch,
        "opts": dict(opts),
        "families": {name: {"rmse": float(mac.spec.rmse),
                            "m_bits": int(mac.spec.m_bits),
                            "n_a_planes": mac.program.n_a_planes,
                            "tp_role": linear_role(name)}
                     for name, mac in macs.items()},
        "fw_dtype": "bfloat16",
    }
    # manifest last + atomically: it gates loading, so a crash anywhere
    # above leaves no readable manifest and the next start rebuilds
    manifest_path = os.path.join(bundle, "manifest.json")
    tmp = f"{manifest_path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, manifest_path)
    return sum(os.path.getsize(os.path.join(bundle, f))
               for f in os.listdir(bundle))


def _load_bundle(bundle: str, key: str, cfg, dev):
    """(macs, delta on ``dev``) from a bundle whose manifest matches
    ``key``, else None.  Raises one of ``_BUNDLE_ERRORS`` when a file is
    missing or unreadable."""
    with open(os.path.join(bundle, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("version") != ARTIFACT_VERSION \
            or manifest.get("key") != key:
        return None
    fw_dtype = manifest.get("fw_dtype", "float32")
    if fw_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"unknown fw_dtype {fw_dtype!r}")
    macs = {name: EncodedMac.load(f"enc_{name}", artifact_dir=bundle)
            for name in manifest["families"]}
    tree = load_array_tree(os.path.join(bundle, "folded.npz"))
    want = np.uint16 if fw_dtype == "bfloat16" else np.float32
    for leaf_key, a in _flat_items(tree):
        if leaf_key.endswith("_fw") and a.dtype != want:
            raise ValueError(f"{leaf_key}: {a.dtype}, manifest says "
                             f"{fw_dtype}")
    return macs, tree_from_reference(tree, dev)


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, prefix + k + "/")
        else:
            yield prefix + k, v


def prepare_encoded_serving(params, cfg, *, m_bits=48, n_samples: int = 128,
                            refine: int = 64, seed: int = 0,
                            calib_batches: int = 4, calib_batch_size: int = 4,
                            calib_seq: int = 64, blend: float = 0.5,
                            cache_dir: Optional[str] = None,
                            macs_override: Optional[dict] = None,
                            force: bool = False, verbose: bool = True,
                            device=None):
    """fp params → encoded-serving params on ``device`` (default: the
    card; params elsewhere are moved there first).

    Returns ``(params_enc, cfg_enc, info)``: ``cfg_enc.mac`` is an
    'encoded_infer' MacConfig carrying the per-family encodings and
    ``params_enc`` additionally holds the folded leaves (the fp tensors are
    shared, not copied).  The first call calibrates, searches (on
    ``device``), folds and writes the bundle under ``cache_dir``; later
    calls with the same params and options load it (``info['loaded']``);
    ``force`` rebuilds.  ``macs_override`` ({family: EncodedMac}, e.g.
    ``exact_encodings()``) skips the search and folds with the given
    encodings, through the same cache.

    ``info``: ``bundle_dir``, ``loaded``, ``n_folded`` (folded linears,
    counted per layer), ``families`` ({family: rmse}), ``roles`` ({family:
    tensor-parallel role}), and ``calib_tokens``, ``bundle_bytes`` and
    ``seconds`` (of each step taken) for the logs."""
    dev = resolve_device(device)
    params = to_device(params, dev)
    bits = cfg.mac.bits
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    opts = dict(bits=bits, m_bits=m_bits, n_samples=n_samples, refine=refine,
                seed=seed, calib_batches=calib_batches,
                calib_batch_size=calib_batch_size, calib_seq=calib_seq,
                blend=blend)
    if macs_override is not None:
        opts["override"] = _macs_fingerprint(macs_override)
    seconds = {}
    t0 = time.perf_counter()
    key = _bundle_key(cfg, params, opts)
    seconds["key"] = time.perf_counter() - t0
    bundle = os.path.join(cache_dir, f"{cfg.arch}-{key}")
    info = {"bundle_dir": bundle, "loaded": False, "calib_tokens": 0,
            "bundle_bytes": 0, "seconds": seconds}

    got = None
    if not force and os.path.exists(os.path.join(bundle, "manifest.json")):
        t0 = time.perf_counter()
        try:
            got = _load_bundle(bundle, key, cfg, dev)
        except _BUNDLE_ERRORS as e:
            if verbose:
                print(f"[encoded-serving] unreadable bundle {bundle} "
                      f"({e!r}) — rebuilding")
        seconds["load"] = time.perf_counter() - t0
    if got is not None:
        macs, delta = got
        info["loaded"] = True
    else:
        if verbose:
            print(f"[encoded-serving] calibrating "
                  f"({calib_batches}×{calib_batch_size}×{calib_seq} tokens)…")
        t0 = time.perf_counter()
        stats = capture_activation_stats(
            params, cfg, n_batches=calib_batches,
            batch_size=calib_batch_size, seq_len=calib_seq, seed=seed)
        seconds["calibrate"] = time.perf_counter() - t0
        info["calib_tokens"] = stats.n_tokens
        if not stats.amax:
            raise ValueError("calibration recorded no linear layers")
        if macs_override is not None:
            macs = dict(macs_override)
        else:
            t0 = time.perf_counter()
            rw = family_row_weights(params, stats, bits, blend)
            seconds["row_weights"] = time.perf_counter() - t0
            if verbose:
                print(f"[encoded-serving] searching encodings for "
                      f"{len(rw)} projection families on {dev}…")
            seconds["search"] = {}
            macs = search_family_encodings(rw, bits, m_bits, n_samples,
                                           refine, seed, verbose=verbose,
                                           device=dev,
                                           timings=seconds["search"])
        t0 = time.perf_counter()
        delta = fold_linear_params(params, stats, macs, bits)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds["fold"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["bundle_bytes"] = _save_bundle(bundle, key, cfg, opts, macs,
                                            delta)
        seconds["write"] = time.perf_counter() - t0

    params_enc = _merge(params, delta)
    cfg_enc = dataclasses.replace(
        cfg, mac=MacConfig(mode="encoded_infer", bits=bits, macs=macs))
    info.update(n_folded=_n_folded(delta),
                families={n: float(m.spec.rmse) for n, m in macs.items()},
                roles={n: linear_role(n) for n in macs})
    if verbose:
        src = "loaded" if info["loaded"] else "built"
        print(f"[encoded-serving] {src} bundle {bundle} "
              f"({info['n_folded']} folded linears, families="
              f"{sorted(info['families'])})")
    return params_enc, cfg_enc, info


def prepare_drafter(params, cfg, *, m_bits=24, verifier=None, **kw):
    """The speculative-decoding drafter pair ``(draft_params, draft_cfg,
    info)`` for ``Engine(spec_decode=k, draft_params=..., draft_cfg=...)``:
    the same fp params through ``prepare_encoded_serving`` at a lower
    ``m_bits`` (coarser encodings, cheaper MACs, lower acceptance).  The
    calibration knobs, ``cache_dir`` and ``device`` pass through ``kw``, so
    drafter bundles sit beside the serving bundle and cache-hit like it.

    ``verifier``: an already built ``(params_enc, cfg_enc)`` pair; when
    its encodings were searched at the same ``m_bits`` the drafter is the
    verifier itself (no second search or fold)."""
    if verifier is not None:
        p_v, c_v = verifier
        mb = {int(m.spec.m_bits)
              for m in (getattr(c_v.mac, "macs", None) or {}).values()}
        if mb == {int(m_bits)}:
            check_drafter(p_v, c_v.mac.mode)
            return p_v, c_v, {"shared_with_verifier": True,
                              "m_bits": int(m_bits)}
    params_d, cfg_d, info = prepare_encoded_serving(
        params, cfg, m_bits=m_bits, **kw)
    check_drafter(params_d, cfg_d.mac.mode)
    info = dict(info, shared_with_verifier=False, m_bits=int(m_bits))
    return params_d, cfg_d, info
