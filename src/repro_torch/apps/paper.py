"""The paper's results from the port: Table 1 (area/power model), the
§3.3 latency/throughput claims, Table 2 (accuracy mechanism), Fig 5 (bit
width vs accuracy and power), Fig 6 (RMSE vs width and samples) and Fig 7
(task-specific arrays for 4-bit non-uniform weights).

Each experiment (``table1``, ``latency``, ``table2``, ``fig5``, ``fig6``,
``fig7``) has ``run(device=None)``, which returns the dict of the
reference's script of the same name under ``benchmarks/`` at its sizes
and seeds, and ``csv_lines(res)``, which gives its CSV rows under the
reference's names.  The CNN's initial weights come from a
``torch.Generator`` seeded 0 (the reference draws them from a JAX key),
so accuracies are the reference's only in distribution; everything else
is drawn from the reference's numpy seeds.

    python -m repro_torch.apps.paper [--only NAME] [--device cpu]

prints ``name,us_per_call,derived`` rows, a ``device`` row first and a
``<name>_wall_s`` row after each experiment; it keeps no cache.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.apps.image_cls import (accuracy, calibrate, cnn_init,
                                        convert_params, finetune_s,
                                        nonuniform_to_int8_params, train_cnn)
from repro_torch.core import gates as G
from repro_torch.core.layers import MacConfig
from repro_torch.core.mac import EncodedMac
from repro_torch.core.search import anneal, binary_search_width, random_search
from repro_torch.data.synthetic import synthetic_images
from repro_torch.device import resolve_device
from repro_torch.hw import (latency_encoded, latency_traditional,
                            mac_array_cost, simulate_latency)
from repro_torch.hw import table1 as hw_table1
from repro_torch.hw.systolic import throughput
from repro_torch.quant.nonuniform import kmeans_levels

FIG5_WIDTHS = (16, 24, 32, 48, 64)
FIG6_WIDTHS = (16, 24, 32, 48, 64, 96, 128)
FT_STEPS = 120           # Table 2's fine-tune steps of the position weights


@dataclasses.dataclass(frozen=True)
class Experiment:
    name: str                       # the reference's suite name
    run: Callable                   # (device=None, ...) -> dict
    csv_lines: Callable             # dict -> list[str]


# --- the CNN's data and training, shared by Table 2 and Fig 5 --------------

def cnn_data(n: int = 6000, n_train: int = 5000):
    """(train images, train labels, val images, val labels)."""
    imgs, labels = synthetic_images(n, seed=0)
    return imgs[:n_train], labels[:n_train], imgs[n_train:], labels[n_train:]


def train_fp(data, device, epochs: int = 8) -> dict:
    """The fp32 net trained on ``data``'s train split from
    ``cnn_init(torch.Generator().manual_seed(0))``."""
    ti, tl = data[0], data[1]
    params = cnn_init(torch.Generator().manual_seed(0), device=device)
    return train_cnn(params, ti, tl, MacConfig(mode="fp"), epochs=epochs)


def prepare(params_fp: dict, mode: str, mac, data, finetune_steps: int = 0):
    """(params, MacConfig): ``params_fp`` converted to ``mode``,
    calibrated on the train split, its position weights fine-tuned
    ``finetune_steps`` steps."""
    ti, tl = data[0], data[1]
    mcfg = MacConfig(mode=mode, mac=mac)
    p = calibrate(convert_params(params_fp, mcfg), ti, mcfg)
    if finetune_steps:
        p = finetune_s(p, ti, tl, mcfg, steps=finetune_steps)
    return p, mcfg


def eval_mode(params_fp: dict, mode: str, mac, data,
              finetune_steps: int = 0) -> float:
    """Validation accuracy of ``prepare``'s params."""
    p, mcfg = prepare(params_fp, mode, mac, data, finetune_steps)
    return accuracy(p, data[2], data[3], mcfg)


def table2_rows(params: dict, mac, data) -> dict:
    """Table 2 of the trained fp net ``params`` with encoding ``mac``."""
    fp = MacConfig(mode="fp")
    acc_fp = accuracy(params, data[2], data[3], fp)
    acc_int8 = eval_mode(params, "int8", mac, data)
    acc_enc = eval_mode(params, "encoded", mac, data)
    acc_enc_ft = eval_mode(params, "encoded", mac, data,
                           finetune_steps=FT_STEPS)
    # 4-bit non-uniform: k-means levels as weights → int8 → encoded array
    p_nu = nonuniform_to_int8_params(params)
    acc_nu_fp = accuracy(p_nu, data[2], data[3], fp)
    acc_nu_int8 = eval_mode(p_nu, "int8", mac, data)
    acc_nu_enc = eval_mode(p_nu, "encoded", mac, data)
    acc_nu_enc_ft = eval_mode(p_nu, "encoded", mac, data,
                              finetune_steps=FT_STEPS)
    return {
        "fp32": acc_fp,
        "uniform8": {"orig": acc_int8, "prop": acc_enc,
                     "prop_finetuned": acc_enc_ft,
                     "acc_loss_ft": acc_int8 - acc_enc_ft},
        "nonuniform4": {"fp_levels": acc_nu_fp, "orig": acc_nu_int8,
                        "prop": acc_nu_enc, "prop_finetuned": acc_nu_enc_ft,
                        "acc_loss_ft": acc_nu_int8 - acc_nu_enc_ft},
        "encoding_rmse": float(mac.spec.rmse),
    }


# --- Table 1 -----------------------------------------------------------------

def _table1_run(device=None) -> dict:
    """Host arithmetic only: ``device`` is not used."""
    rows = hw_table1(m_bits=48, sizes=[32, 48, 64, 128, 256, 512, 1024])
    out = []
    for r in rows:
        rec = {"N": r["N"],
               "power_red_model": round(r["power_red"], 4),
               "area_red_model": round(r["area_red"], 4),
               "power_prop_w": round(r["power_prop_w"], 3),
               "area_prop_mm2": round(r["area_prop_mm2"], 3)}
        if "paper_power_red" in r:
            rec["power_red_paper"] = round(r["paper_power_red"], 4)
            rec["area_red_paper"] = round(r["paper_area_red"], 4)
            rec["power_delta_pp"] = round(
                100 * (r["power_red"] - r["paper_power_red"]), 2)
            rec["area_delta_pp"] = round(
                100 * (r["area_red"] - r["paper_area_red"]), 2)
        out.append(rec)
    return {"rows": out}


def _table1_csv(res) -> list:
    lines = []
    for r in res["rows"]:
        lines.append(f"table1_area_red_N{r['N']},0,{r['area_red_model']:.4f}")
        lines.append(
            f"table1_power_red_N{r['N']},0,{r['power_red_model']:.4f}")
    return lines


# --- §3.3 latency / throughput ----------------------------------------------

def _latency_run(device=None) -> dict:
    """The event simulator against both closed forms (host only)."""
    out = {}
    for n in (32, 64, 128, 256):
        row = {}
        for m in (1, 4, 16):
            st = simulate_latency(n, m, "trad")
            se = simulate_latency(n, m, "prop")
            if st != latency_traditional(n, m) or \
                    se != latency_encoded(n, m):
                raise AssertionError(f"simulated latency at n={n} m={m} "
                                     "is not the closed form's")
            row[f"m{m}"] = {
                "trad_cycles": st, "prop_cycles": se,
                "speedup": st / se,
                "thr_trad": throughput(n, m, "trad"),
                "thr_prop": throughput(n, m, "prop"),
            }
        out[str(n)] = row
    return out


def _latency_csv(res) -> list:
    return [f"latency_N{n}_{m},0,{r['speedup']:.4f}"
            for n, row in res.items() for m, r in row.items()]


# --- Table 2 -----------------------------------------------------------------

def _table2_run(device=None) -> dict:
    dev = resolve_device(device)
    mac = EncodedMac.default(device=dev)
    data = cnn_data()
    return table2_rows(train_fp(data, dev), mac, data)


def _table2_csv(res) -> list:
    u, n = res["uniform8"], res["nonuniform4"]
    return [
        f"table2_fp32_acc,0,{res['fp32']:.4f}",
        f"table2_u8_orig,0,{u['orig']:.4f}",
        f"table2_u8_prop,0,{u['prop']:.4f}",
        f"table2_u8_prop_ft,0,{u['prop_finetuned']:.4f}",
        f"table2_u8_accloss_ft,0,{u['acc_loss_ft']:.4f}",
        f"table2_nu4_orig,0,{n['orig']:.4f}",
        f"table2_nu4_prop_ft,0,{n['prop_finetuned']:.4f}",
    ]


# --- Fig 5 -------------------------------------------------------------------

def _fig5_run(device=None, widths=FIG5_WIDTHS) -> dict:
    dev = resolve_device(device)
    data = cnn_data()
    params = train_fp(data, dev)
    acc_fp = accuracy(params, data[2], data[3], MacConfig(mode="fp"))
    out = {}
    for w in widths:
        res = random_search(seed=10 + w, m_bits=w, n_samples=256, batch=64,
                            device=dev)
        res = anneal(res.spec, seed=20 + w, iters=1536, batch=64, device=dev)
        mac = EncodedMac.from_spec(res.spec)
        hw = mac_array_cost(256, m_bits=w, design="prop")
        out[str(w)] = {"rmse": float(res.spec.rmse),
                       "acc": eval_mode(params, "encoded", mac, data),
                       "power_w": hw["power_w"], "area_mm2": hw["area_mm2"]}
    return {"fp32_acc": acc_fp, "per_width": out}


def _fig5_csv(res) -> list:
    lines = [f"fig5_fp32_acc,0,{res['fp32_acc']:.4f}"]
    for w, r in res["per_width"].items():
        lines.append(f"fig5_acc_width{w},0,{r['acc']:.4f}")
        lines.append(f"fig5_power_width{w},0,{r['power_w']:.3f}")
    return lines


# --- Fig 6 -------------------------------------------------------------------

def _fig6_run(device=None, widths=FIG6_WIDTHS) -> dict:
    """(b) RMSE vs samples at M = 48 and the annealing curve beyond the
    paper; (a) the best RMSE per width, and the binary search against a
    target 5% above M = 48's."""
    dev = resolve_device(device)
    res = random_search(seed=0, m_bits=48, n_samples=10_000, batch=64,
                        rel_tol=0.0, patience=10 ** 9, device=dev)
    trace = res.rmse_trace
    marks = [10, 30, 100, 300, 1000, 3000, 10_000]
    curve = {str(m): float(trace[min(m, len(trace)) - 1]) for m in marks}
    ann = anneal(res.spec, seed=1, iters=3000, batch=64, device=dev)
    per_width = {}
    for w in widths:
        r = random_search(seed=2, m_bits=w, n_samples=768, batch=64,
                          rel_tol=0.0, patience=10 ** 9, device=dev)
        per_width[str(w)] = float(r.spec.rmse)
    target = per_width["48"] * 1.05
    spec, hist = binary_search_width(seed=3, target_rmse=target, lo=16,
                                     hi=128, n_samples=512, device=dev)
    return {"rmse_vs_samples": curve,
            "rmse_random_10k": float(res.spec.rmse),
            "rmse_anneal_3k": float(ann.spec.rmse),
            "rmse_vs_width": per_width,
            "binary_search": {"found_width": spec.m_bits,
                              "target": float(target),
                              "history": hist}}


def _fig6_csv(res) -> list:
    lines = [f"fig6_rmse_random10k,0,{res['rmse_random_10k']:.2f}",
             f"fig6_rmse_anneal3k,0,{res['rmse_anneal_3k']:.2f}",
             f"fig6_binary_search_width,0,"
             f"{res['binary_search']['found_width']}"]
    for w, v in res["rmse_vs_width"].items():
        lines.append(f"fig6_rmse_width{w},0,{v:.2f}")
    return lines


# --- Fig 7 -------------------------------------------------------------------

def _fig7_run(device=None) -> dict:
    """The 16×16 table of non-uniform LEVEL PRODUCTS searched directly;
    the target is the 48-bit random-search encoding's relative RMSE
    (``enc48_8x8_random`` if cached, else ``EncodedMac.default()``)."""
    dev = resolve_device(device)
    data = cnn_data(2000, 1500)
    params = train_fp(data, dev, epochs=3)
    w_all = torch.cat([v["w"].reshape(-1) for v in params.values()])
    levels = kmeans_levels(w_all, bits=4).cpu().numpy()
    lv = levels / np.abs(levels).max()
    acts = np.linspace(0, 1, 16)             # 4-bit uniform activations
    values = G.level_products(acts, lv)
    try:
        ref = EncodedMac.load("enc48_8x8_random")
    except FileNotFoundError:
        ref = EncodedMac.default(device=dev)
    target_rel = ref.spec.rmse / np.sqrt(np.mean(
        G.signed_products(8, 8) ** 2))
    target = float(target_rel * np.sqrt(np.mean(values ** 2)))
    spec, hist = binary_search_width(
        seed=1, target_rmse=target, lo=8, hi=64, n_samples=512,
        bits_a=4, bits_b=4, values=values, refine=256, device=dev)
    hw_gen = mac_array_cost(256, 48, "prop")
    hw_task = mac_array_cost(256, spec.m_bits, "prop")
    return {
        "task_specific_width": spec.m_bits,
        "general_width": 48,
        "target_rmse": target,
        "found_rmse": float(spec.rmse),
        "power_general_w": hw_gen["power_w"],
        "power_task_w": hw_task["power_w"],
        "area_general_mm2": hw_gen["area_mm2"],
        "area_task_mm2": hw_task["area_mm2"],
        "history": hist,
    }


def _fig7_csv(res) -> list:
    return [
        f"fig7_task_width,0,{res['task_specific_width']}",
        f"fig7_power_task_w,0,{res['power_task_w']:.3f}",
        f"fig7_area_task_mm2,0,{res['area_task_mm2']:.3f}",
    ]


table1 = Experiment("table1_hw", _table1_run, _table1_csv)
latency = Experiment("latency_throughput", _latency_run, _latency_csv)
table2 = Experiment("table2_accuracy", _table2_run, _table2_csv)
fig5 = Experiment("fig5_bitwidth", _fig5_run, _fig5_csv)
fig6 = Experiment("fig6_rmse", _fig6_run, _fig6_csv)
fig7 = Experiment("fig7_taskspecific", _fig7_run, _fig7_csv)
# the reference's suite order
EXPERIMENTS = (table1, latency, fig6, fig7, table2, fig5)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None,
                    help="run the experiments whose name contains this")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    where = (f"{torch.cuda.get_device_name(dev)} x"
             f"{torch.cuda.device_count()}" if dev.type == "cuda" else "cpu")
    print("name,us_per_call,derived")
    print(f"device,0,{where}", flush=True)
    for d in EXPERIMENTS:
        if args.only and args.only not in d.name:
            continue
        t0 = time.perf_counter()
        res = d.run(device=dev)
        for line in d.csv_lines(res):
            print(line)
        wall = time.perf_counter() - t0
        print(f"{d.name}_wall_s,{wall * 1e6:.0f},{wall:.1f}", flush=True)


if __name__ == "__main__":
    main()
