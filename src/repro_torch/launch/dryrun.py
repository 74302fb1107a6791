"""Dry run: each registry arch at full depth × ``configs.SHAPES`` × mesh
(1, TP 2, TP 4 where the arch shards, or one ``--mesh DxM``), laid out on
the ``meta`` device: no weights are made and no card is needed (the
port's counterpart of ``repro/launch/dryrun.py``, which lowers and
compiles every cell for a TPU mesh).

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape decode_32k --tp 2                                  # one cell
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh 2x2  # D x M

For each cell, a rank's bytes:

  * ``params_bytes``: its slice of the params (``shard_params`` on a
    stand-in mesh: the model axis's slices, which a data axis does not
    cut further; the whole tree at 1x1);
  * ``fw_bytes``: the folded bitplanes encoded serving adds beside them,
    ``U·k·n·2`` bytes (bf16) for every roled 2-D linear it folds (not a
    router's or the MTP head's) at ``U = 8``;
  * ``kv_bytes``: the dense KV cache of ``global_batch × seq_len`` at its
    kv heads and its data row's batch rows (prefill and decode cells);
    ``pool_bytes``: the paged pools that hold the same tokens
    (``POOL_PAGE`` tokens a page, plus the scratch page) at its kv heads,
    the whole page count on every data row (paged archs; None
    elsewhere); ``grad_opt_bytes``: f32 gradients and AdamW's two
    moments (train cells); both caches follow the serving rules of
    ``parallel/statesharding.py`` (``SERVING_CACHE``);

the roofline terms of one step from ``launch/roofline.py`` (its share of
``model_flops`` at bf16 peak, and every byte above moved once: read
params and KV, or read and write params, grads and moments) and whether
it fits one 80 GB card (``fits``, and ``fits_encoded`` with the folded
bitplanes; ``fits_paged`` with the pools in place of the dense cache).
Activations are not counted.  Each cell's JSON goes to
``build/dryrun/<arch>__<shape>__tp<N>.json`` (``__<D>x<M>.json`` with a
data axis; git-ignored) and one line a cell is printed.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
from typing import Optional

import torch

FOLD_U = 8
TPS = (1, 2, 4)
POOL_PAGE = 16                   # tokens a page of the paged pools


def _out_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "..", "build", "dryrun")


def _bytes(tree) -> int:
    from repro_torch.analysis.shardcheck import leaf_paths
    return sum(t.numel() * t.element_size() for _, t in leaf_paths(tree))


def _fw_bytes(tree, U: int = FOLD_U) -> int:
    """``U·k·n·2`` bytes for every 2-D linear serving folds: a roled
    linear's weight, but not the router's (its routing runs fp) nor the
    MTP head's (serving never runs it)."""
    from repro_torch.analysis.shardcheck import leaf_paths
    from repro_torch.parallel.sharding import LINEAR_ROLES
    return sum(U * t.numel() * 2 for path, t in leaf_paths(tree)
               if t.dim() == 2 and path.rsplit("/", 1)[-1] in LINEAR_ROLES
               and not path.startswith("mtp/") and "/router/" not in path)


def _tag(tp: int, n_data: int = 1) -> str:
    return f"tp{tp}" if n_data == 1 else f"{n_data}x{tp}"


def shards_at(cfg, tp: int, n_data: int = 1) -> Optional[str]:
    """Why ``cfg`` does not run on a ``n_data x tp`` mesh (None: it
    does): refused by ``shard_params``, or no part of it splits at
    ``tp``."""
    from repro_torch.analysis.shardcheck import LayoutMesh, serving_refusal
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import splits
    if tp == 1 and n_data == 1:
        return None
    why = serving_refusal(cfg)
    if why is not None:
        return why
    if tp == 1:
        return None
    with set_mesh(LayoutMesh(tp)):
        if all(v == 1 for v in splits(cfg).values()):
            return f"no part of {cfg.arch} divides over {tp} ranks"
    return None


def cell(cfg, shape, tp: int = 1, params=None, n_data: int = 1) -> dict:
    """One cell's record (module docstring) on a ``n_data x tp`` mesh;
    ``params``: the arch's tree (default: built on the meta device)."""
    from repro_torch.analysis.shardcheck import (LayoutMesh, leaf_paths,
                                                 meta_params)
    from repro_torch.launch import roofline
    from repro_torch.models import init_cache, supports_paged_cache
    from repro_torch.models.lm import paged_cache_layout
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import shard_params
    from repro_torch.parallel.statesharding import cache_rows
    params = meta_params(cfg) if params is None else params
    mesh = LayoutMesh(tp, n_data=n_data) if tp * n_data > 1 else None
    mine = shard_params(params, cfg, mesh) if mesh is not None else params
    pb, fw = _bytes(mine), _fw_bytes(mine)
    n_el = sum(t.numel() for _, t in leaf_paths(mine))
    B, S = shape.global_batch, shape.seq_len
    kv = grad_opt = 0
    pool = None
    if shape.kind == "train":
        grad_opt = 3 * n_el * 4
        moved = 2 * (pb + grad_opt)
    else:
        lo, hi = cache_rows("k", B, mesh)
        with set_mesh(mesh):
            kv = _bytes(init_cache(cfg, hi - lo, S, device="meta")["layers"])
            if supports_paged_cache(cfg):
                lo, hi = cache_rows(
                    "pool_k", B * -(-S // POOL_PAGE) + 1, mesh)
                pool = sum(math.prod(shp) * torch.empty(
                    (), dtype=dt, device="meta").element_size()
                    for layer in paged_cache_layout(cfg, hi - lo, POOL_PAGE)
                    for shp, dt in layer.values())
        moved = pb + kv
    ops = roofline.model_flops(cfg, shape.kind, S, B) / (tp * n_data)
    rl = roofline.Roofline(moved, ops, roofline.PEAK_BF16)
    total = pb + kv + grad_opt
    return {"arch": cfg.arch, "shape": shape.name, "kind": shape.kind,
            "tp": tp, "n_data": n_data, "mesh": f"{n_data}x{tp}",
            "global_batch": B, "seq_len": S,
            "params_bytes": pb, "fw_bytes": fw, "kv_bytes": kv,
            "pool_bytes": pool,
            "grad_opt_bytes": grad_opt, "total_bytes": total,
            "fits": total <= roofline.HBM_BYTES,
            "fits_encoded": (total + fw <= roofline.HBM_BYTES
                             if shape.kind != "train" else None),
            "fits_paged": (pb + pool <= roofline.HBM_BYTES
                           if pool is not None else None),
            "roofline": rl.as_dict(), "card": roofline.CARD}


def sweep(archs=None, shapes=None, tps=TPS, out_dir: Optional[str] = None,
          n_data: int = 1):
    """Every cell (at each model axis of ``tps`` under a data axis of
    ``n_data``); yields its record (a skip carries ``skipped``)."""
    from repro_torch.analysis.shardcheck import meta_params
    from repro_torch.configs import SHAPES, get_config, list_archs
    from repro_torch.models import runnable
    for arch in archs or list_archs():
        cfg = get_config(arch)
        params = meta_params(cfg)
        for name in shapes or list(SHAPES):
            shape = SHAPES[name]
            ok, why = runnable(cfg, shape)
            for tp in tps:
                base = {"arch": arch, "shape": name, "tp": tp,
                        "n_data": n_data}
                reason = why if not ok else shards_at(cfg, tp, n_data)
                rec = dict(base, skipped=reason) if reason else \
                    cell(cfg, shape, tp, params, n_data)
                if out_dir:
                    os.makedirs(out_dir, exist_ok=True)
                    path = os.path.join(
                        out_dir, f"{arch}__{name}__{_tag(tp, n_data)}.json")
                    with open(path, "w", encoding="utf-8") as f:
                        json.dump(rec, f, indent=1)
                yield rec


def main(argv=None) -> int:
    from repro_torch.configs import SHAPES, list_archs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--tp", type=int, choices=TPS, default=None)
    ap.add_argument("--mesh", default=None, metavar="DxM",
                    help="one data x model mesh instead of the TP sweep "
                         "(e.g. 2x2: bytes a rank of a 2-row data axis)")
    ap.add_argument("--out", default=_out_dir(),
                    help="directory of the cells' JSON (default: "
                         "build/dryrun)")
    args = ap.parse_args(argv)
    n_data, tps = 1, (args.tp,) if args.tp else TPS
    if args.mesh:
        m = re.fullmatch(r"(\d+)x(\d+)", args.mesh)
        if m is None or min(int(m.group(1)), int(m.group(2))) < 1:
            ap.error(f"--mesh {args.mesh!r}: expected 'DxM' (e.g. 2x2)")
        n_data, tps = int(m.group(1)), (int(m.group(2)),)
    for rec in sweep([args.arch] if args.arch else None,
                     [args.shape] if args.shape else None,
                     tps, args.out, n_data):
        tag = (f"{rec['arch']:22s} {rec['shape']:12s} "
               f"{_tag(rec['tp'], n_data)}")
        if "skipped" in rec:
            print(f"{tag} SKIP: {rec['skipped']}")
            continue
        r = rec["roofline"]
        pools = ("" if rec["pool_bytes"] is None else
                 f"pools {rec['pool_bytes'] / 1e9:9.2f} GB ")
        print(f"{tag} params {rec['params_bytes'] / 1e9:8.2f} GB "
              f"fw(U=8) {rec['fw_bytes'] / 1e9:8.2f} GB "
              f"kv {rec['kv_bytes'] / 1e9:9.2f} GB {pools}"
              f"grad+opt {rec['grad_opt_bytes'] / 1e9:8.2f} GB "
              f"{'fits' if rec['fits'] else 'DOES NOT FIT'} 80 GB; bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    print(f"cells -> {os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
