"""Dry run: each registry arch at full depth × ``configs.SHAPES`` × mesh
(1, TP 2, TP 4 where the arch shards), laid out on the ``meta`` device:
no weights are made and no card is needed (the port's counterpart of
``repro/launch/dryrun.py``, which lowers and compiles every cell for a
TPU mesh).

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # sweep
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape decode_32k --tp 2                                  # one cell

For each cell, a rank's bytes:

  * ``params_bytes``: its slice of the params (``shard_params`` on a
    stand-in model axis; the whole tree at TP 1);
  * ``fw_bytes``: the folded bitplanes encoded serving adds beside them,
    ``U·k·n·2`` bytes (bf16) for every roled 2-D linear at ``U = 8``;
  * ``kv_bytes``: the dense KV cache of ``global_batch × seq_len`` at its
    kv heads (prefill and decode cells); ``grad_opt_bytes``: f32
    gradients and AdamW's two moments (train cells);

the roofline terms of one step from ``launch/roofline.py`` (its share of
``model_flops`` at bf16 peak, and every byte above moved once: read
params and KV, or read and write params, grads and moments) and whether
it fits one 80 GB card (``fits``, and ``fits_encoded`` with the folded
bitplanes).  Activations are not counted.  Each cell's JSON goes to
``build/dryrun/<arch>__<shape>__tp<N>.json`` (git-ignored) and one line a
cell is printed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

FOLD_U = 8
TPS = (1, 2, 4)


def _out_dir() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "..", "build", "dryrun")


def _bytes(tree) -> int:
    from repro_torch.analysis.shardcheck import leaf_paths
    return sum(t.numel() * t.element_size() for _, t in leaf_paths(tree))


def _fw_bytes(tree, U: int = FOLD_U) -> int:
    from repro_torch.analysis.shardcheck import leaf_paths
    from repro_torch.parallel.sharding import LINEAR_ROLES
    return sum(U * t.numel() * 2 for path, t in leaf_paths(tree)
               if t.dim() == 2 and path.rsplit("/", 1)[-1] in LINEAR_ROLES)


def shards_at(cfg, tp: int) -> Optional[str]:
    """Why ``cfg`` does not run at ``tp`` ranks (None: it does): refused
    by ``shard_params``, or no part of it splits at ``tp``."""
    from repro_torch.analysis.shardcheck import LayoutMesh, serving_refusal
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import splits
    if tp == 1:
        return None
    why = serving_refusal(cfg)
    if why is not None:
        return why
    with set_mesh(LayoutMesh(tp)):
        if all(v == 1 for v in splits(cfg).values()):
            return f"no part of {cfg.arch} divides over {tp} ranks"
    return None


def cell(cfg, shape, tp: int = 1, params=None) -> dict:
    """One cell's record (module docstring); ``params``: the arch's tree
    (default: built on the meta device)."""
    from repro_torch.analysis.shardcheck import (LayoutMesh, leaf_paths,
                                                 meta_params)
    from repro_torch.launch import roofline
    from repro_torch.models import init_cache
    from repro_torch.parallel.mesh import set_mesh
    from repro_torch.parallel.sharding import shard_params
    params = meta_params(cfg) if params is None else params
    mesh = LayoutMesh(tp) if tp > 1 else None
    mine = shard_params(params, cfg, mesh) if mesh is not None else params
    pb, fw = _bytes(mine), _fw_bytes(mine)
    n_el = sum(t.numel() for _, t in leaf_paths(mine))
    B, S = shape.global_batch, shape.seq_len
    kv = grad_opt = 0
    if shape.kind == "train":
        grad_opt = 3 * n_el * 4
        moved = 2 * (pb + grad_opt)
    else:
        with set_mesh(mesh):
            kv = _bytes(init_cache(cfg, B, S, device="meta")["layers"])
        moved = pb + kv
    ops = roofline.model_flops(cfg, shape.kind, S, B) / tp
    rl = roofline.Roofline(moved, ops, roofline.PEAK_BF16)
    total = pb + kv + grad_opt
    return {"arch": cfg.arch, "shape": shape.name, "kind": shape.kind,
            "tp": tp, "global_batch": B, "seq_len": S,
            "params_bytes": pb, "fw_bytes": fw, "kv_bytes": kv,
            "grad_opt_bytes": grad_opt, "total_bytes": total,
            "fits": total <= roofline.HBM_BYTES,
            "fits_encoded": (total + fw <= roofline.HBM_BYTES
                             if shape.kind != "train" else None),
            "roofline": rl.as_dict(), "card": roofline.CARD}


def sweep(archs=None, shapes=None, tps=TPS, out_dir: Optional[str] = None):
    """Every cell; yields its record (a skip carries ``skipped``)."""
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
                base = {"arch": arch, "shape": name, "tp": tp}
                reason = why if not ok else shards_at(cfg, tp)
                rec = dict(base, skipped=reason) if reason else \
                    cell(cfg, shape, tp, params)
                if out_dir:
                    os.makedirs(out_dir, exist_ok=True)
                    path = os.path.join(out_dir,
                                        f"{arch}__{name}__tp{tp}.json")
                    with open(path, "w", encoding="utf-8") as f:
                        json.dump(rec, f, indent=1)
                yield rec


def main(argv=None) -> int:
    from repro_torch.configs import SHAPES, list_archs
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(), default=None)
    ap.add_argument("--shape", choices=list(SHAPES), default=None)
    ap.add_argument("--tp", type=int, choices=TPS, default=None)
    ap.add_argument("--out", default=_out_dir(),
                    help="directory of the cells' JSON (default: "
                         "build/dryrun)")
    args = ap.parse_args(argv)
    for rec in sweep([args.arch] if args.arch else None,
                     [args.shape] if args.shape else None,
                     (args.tp,) if args.tp else TPS, args.out):
        tag = f"{rec['arch']:22s} {rec['shape']:12s} tp{rec['tp']}"
        if "skipped" in rec:
            print(f"{tag} SKIP: {rec['skipped']}")
            continue
        r = rec["roofline"]
        print(f"{tag} params {rec['params_bytes'] / 1e9:8.2f} GB "
              f"fw(U=8) {rec['fw_bytes'] / 1e9:8.2f} GB "
              f"kv {rec['kv_bytes'] / 1e9:9.2f} GB "
              f"grad+opt {rec['grad_opt_bytes'] / 1e9:8.2f} GB "
              f"{'fits' if rec['fits'] else 'DOES NOT FIT'} 80 GB; bound "
              f"{r['bound_ms']:.3f} ms ({r['bound_by']})")
    print(f"cells -> {os.path.abspath(args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
