"""Port parity: the paper's experiments (``repro_torch.apps.paper``) against
the JAX package on the CPU.

- Table 2's pipeline at a reduced size (600 images, 1 epoch, 5 fine-tune
  steps, calibration on 64 images), composed from the reference's
  functions as ``benchmarks/table2_accuracy.py`` composes them, and by
  the port's ``paper.prepare``: the trained params within 2e-3 of each
  other, and, from the reference's trained net, every row's validation
  predictions equal, or apart only where the first int8 code apart lies
  within ``ORIGIN_TOL`` of a .5 rounding boundary on both sides (or,
  with no code apart, where the reference's two top logits lie within
  ``TIE_RTOL`` of max|logit|); ``paper.table2_rows`` puts each row's
  accuracy under the reference's key.
- Table 1 and the latency table equal what ``benchmarks/table1_hw.py``
  and ``benchmarks/latency_throughput.py`` compute, rebuilt here from
  ``repro.hw``; every ``csv_lines`` gives the reference scripts' names;
  the CLI prints them.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.apps import image_cls as J  # noqa: E402
from repro.core import layers as JL  # noqa: E402
from repro.hw import latency_encoded as j_lat_enc  # noqa: E402
from repro.hw import latency_traditional as j_lat_trad  # noqa: E402
from repro.hw import simulate_latency as j_sim  # noqa: E402
from repro.hw import table1 as j_table1  # noqa: E402
from repro.hw.systolic import throughput as j_thr  # noqa: E402
from repro.data.synthetic import synthetic_images as j_images  # noqa: E402

from repro_torch.apps import image_cls as T  # noqa: E402
from repro_torch.apps import paper  # noqa: E402
from repro_torch.core import layers as TL  # noqa: E402
from repro_torch.nn.common import activation_recorder  # noqa: E402

from test_torch_image_cls import encodings, to_numpy  # noqa: E402

N_IMAGES, N_TRAIN, EPOCHS, FT_STEPS = 600, 500, 1, 5
PARAM_ATOL = 2e-3
# a split's origin: an int8 code that f32 order moved across .5, both
# values within this of the boundary (x / scale units)
ORIGIN_TOL = 1e-3
# with no code apart, a split only where the two top logits tie to this
# share of max|logit|
TIE_RTOL = 1e-4
LAYERS = ("c1", "c2", "c3", "d1", "d2")
CAL_N = 64               # calibration images (the experiments take 256)


@pytest.fixture(scope="module")
def pipeline():
    """The reduced data, the reference's and the port's trained nets from
    the reference's initial params, and the encodings."""
    imgs, labels = j_images(N_IMAGES, seed=0)
    data = (imgs[:N_TRAIN], labels[:N_TRAIN], imgs[N_TRAIN:],
            labels[N_TRAIN:])
    p0 = to_numpy(J.cnn_init(jax.random.PRNGKey(0)))
    jp = J.train_cnn(jax.random.PRNGKey(0), data[0], data[1],
                     JL.MacConfig(mode="fp"), epochs=EPOCHS)
    tp = T.train_cnn(T.params_from_jax(p0, "cpu"), data[0], data[1],
                     TL.MacConfig(mode="fp"), epochs=EPOCHS)
    nu = jax.jit(J.nonuniform_to_int8_params)(jp)
    return {"data": data, "ref": to_numpy(jp), "port": tp,
            "nu": to_numpy(nu), "macs": encodings()}


def test_trained_params_match_reference(pipeline):
    for k in LAYERS:
        err = np.abs(pipeline["ref"][k]["w"]
                     - pipeline["port"][k]["w"].numpy()).max()
        assert err <= PARAM_ATOL, (k, err)


_JITS = {}


def _ref_jit(fn, mcfg, **kw):
    """``fn`` (the reference's calibrate, forward or layer inputs) under
    ``jax.jit`` for ``mcfg``, compiled once for the rows that share it."""
    key = (fn, mcfg.mode, id(mcfg.mac))
    if key not in _JITS:
        _JITS[key] = jax.jit(functools.partial(fn, mcfg=mcfg, **kw))
    return _JITS[key]


def _ref_prepare(params, mode, jmac, data, ft):
    """The reference script's ``eval_mode`` up to its accuracy: the
    prepared params (the reference's eager calibrate under ``jax.jit``)."""
    mcfg = JL.MacConfig(mode=mode, mac=jmac)
    p = J.convert_params(jax.tree_util.tree_map(jnp.asarray, params), mcfg)
    p = _ref_jit(J.calibrate, mcfg, n=CAL_N)(p, jnp.asarray(data[0]))
    if ft:
        p = J.finetune_s(p, data[0], data[1], mcfg, steps=ft)
    return p, mcfg


def _patches(h, stride):
    n, _, _, c = h.shape
    p = jax.lax.conv_general_dilated_patches(
        h, (3, 3), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _, ph, pw, _ = p.shape
    return jnp.swapaxes(p.reshape(n, ph, pw, c, 9), -1, -2).reshape(
        n, ph, pw, 9 * c)


def _ref_inputs(p, x, mcfg):
    """Each layer's input in the reference's forward (``cnn_apply``)."""
    relu = jax.nn.relu
    ins = [_patches(x, 1)]
    h = relu(JL.conv_apply(p["c1"], x, mcfg, 3, 3))
    ins.append(_patches(h, 2))
    h = relu(JL.conv_apply(p["c2"], h, mcfg, 3, 3, stride=2))
    ins.append(_patches(h, 2))
    h2 = relu(JL.conv_apply(p["c3"], h, mcfg, 3, 3, stride=2)).reshape(
        x.shape[0], -1)
    ins.append(h2)
    ins.append(relu(JL.dense_apply(p["d1"], h2, mcfg)))
    return ins


def _port_inputs(p, x, mcfg):
    got = []
    with torch.no_grad(), activation_recorder(
            lambda name, w, a: got.append(a.numpy().copy())):
        T.cnn_apply(p, torch.from_numpy(x), mcfg)
    return got


def _locate(jp, jc, tp, tc, x):
    """Why each image of ``x`` is predicted apart: the first layer whose
    int8 input codes differ, with both values before rounding, or None
    (also in fp, which has no codes).  One forward of all the images in
    each package."""
    if "a_scale" not in jp["c1"]:
        return [None] * len(x)
    ji = [np.asarray(a) for a in _ref_jit(_ref_inputs, jc)(
        jp, jnp.asarray(x))]
    ti = _port_inputs(tp, x, tc)
    out = []
    for i in range(len(x)):
        origin = None
        for k, a, b in zip(LAYERS, ji, ti):
            va = a[i].reshape(-1) / float(jp[k]["a_scale"])
            vb = b[i].reshape(-1) / float(tp[k]["a_scale"])
            apart = np.flatnonzero(np.round(va) != np.round(vb))
            if apart.size:
                origin = k, float(va[apart[0]]), float(vb[apart[0]])
                break
        out.append(origin)
    return out


def _half_off(v):
    return abs(abs(v) % 1.0 - 0.5)


ROWS = [("fp32", "fp", False, None, 0),
        ("u8_orig", "int8", False, None, 0),
        ("u8_prop", "encoded", False, "searched24", 0),
        ("u8_prop_ft", "encoded", False, "searched24", FT_STEPS),
        ("u8_exact", "encoded", False, "exact", 0),
        ("nu4_fp_levels", "fp", True, None, 0),
        ("nu4_orig", "int8", True, None, 0),
        ("nu4_prop_ft", "encoded", True, "searched24", FT_STEPS)]


@pytest.mark.parametrize("row,mode,nu,enc,ft", ROWS,
                         ids=[r[0] for r in ROWS])
def test_table2_rows_match_reference(pipeline, row, mode, nu, enc, ft,
                                     monkeypatch):
    monkeypatch.setattr(paper, "calibrate",
                        functools.partial(T.calibrate, n=CAL_N))
    data = pipeline["data"]
    jmac, tmac = pipeline["macs"][enc] if enc else (None, None)
    base = pipeline["nu" if nu else "ref"]
    jp, jc = _ref_prepare(base, mode, jmac, data, ft)
    tp, tc = paper.prepare(T.params_from_jax(base, "cpu"), mode, tmac, data,
                           finetune_steps=ft)
    vi, vl = data[2], data[3]
    logits = np.asarray(_ref_jit(J.cnn_apply, jc)(jp, jnp.asarray(vi)))
    ref_pred = logits.argmax(-1)
    port_pred = T.predict(tp, vi, tc)
    apart = np.flatnonzero(ref_pred != port_pred)
    origins = _locate(jp, jc, tp, tc, vi[apart]) if apart.size else []
    for i, origin in zip(apart, origins):
        if origin is None:
            top = np.sort(logits[i])[-2:]
            assert top[1] - top[0] <= TIE_RTOL * np.abs(logits[i]).max(), \
                (row, i, logits[i])
        else:
            k, va, vb = origin
            assert _half_off(va) <= ORIGIN_TOL and \
                _half_off(vb) <= ORIGIN_TOL, (row, i, origin)
    assert T.accuracy(tp, vi, vl, tc) == float((port_pred == vl).mean())


def test_table2_rows_compose_the_rows(monkeypatch):
    """``paper.table2_rows`` puts each step's accuracy under the
    reference script's key (``eval_mode`` and ``accuracy`` recorded,
    not run: the steps are held against the reference above)."""
    got = {}

    def record(tag, mode, ft):
        return got.setdefault((tag, mode, ft), float(len(got) + 1))

    monkeypatch.setattr(paper, "eval_mode",
                        lambda p, mode, mac, data, finetune_steps=0:
                        record(p["tag"], mode, finetune_steps))
    monkeypatch.setattr(paper, "accuracy",
                        lambda p, *a: record(p["tag"], "fp", 0))
    monkeypatch.setattr(paper, "nonuniform_to_int8_params",
                        lambda p: {"tag": "nu4"})
    mac = type("Mac", (), {"spec": type("Spec", (), {"rmse": 929.5})})()
    res = paper.table2_rows({"tag": "u8"}, mac, (None,) * 4)
    for key, tag in (("uniform8", "u8"), ("nonuniform4", "nu4")):
        row = res[key]
        assert row["orig"] == got[(tag, "int8", 0)]
        assert row["prop"] == got[(tag, "encoded", 0)]
        assert row["prop_finetuned"] == got[(tag, "encoded", 120)]
        assert row["acc_loss_ft"] == row["orig"] - row["prop_finetuned"]
    assert res["fp32"] == got[("u8", "fp", 0)]
    assert res["nonuniform4"]["fp_levels"] == got[("nu4", "fp", 0)]
    assert res["encoding_rmse"] == 929.5 and len(got) == 8


def test_table2_csv_names_are_the_reference_scripts():
    res = {"fp32": 0.9, "encoding_rmse": 1.0,
           "uniform8": {"orig": 0.9, "prop": 0.1, "prop_finetuned": 0.2,
                        "acc_loss_ft": 0.7},
           "nonuniform4": {"orig": 0.9, "prop_finetuned": 0.3}}
    names = [ln.split(",")[0] for ln in paper.table2.csv_lines(res)]
    assert names == ["table2_fp32_acc", "table2_u8_orig", "table2_u8_prop",
                     "table2_u8_prop_ft", "table2_u8_accloss_ft",
                     "table2_nu4_orig", "table2_nu4_prop_ft"]


def _ref_table1():
    """``benchmarks/table1_hw.py:run``, rebuilt from ``repro.hw``."""
    out = []
    for r in j_table1(m_bits=48, sizes=[32, 48, 64, 128, 256, 512, 1024]):
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


def _ref_latency():
    """``benchmarks/latency_throughput.py:run``, rebuilt from
    ``repro.hw``."""
    out = {}
    for n in (32, 64, 128, 256):
        row = {}
        for m in (1, 4, 16):
            st, se = j_sim(n, m, "trad"), j_sim(n, m, "prop")
            assert st == j_lat_trad(n, m) and se == j_lat_enc(n, m)
            row[f"m{m}"] = {"trad_cycles": st, "prop_cycles": se,
                            "speedup": st / se,
                            "thr_trad": j_thr(n, m, "trad"),
                            "thr_prop": j_thr(n, m, "prop")}
        out[str(n)] = row
    return out


@pytest.mark.parametrize("name", ["table1", "latency"])
def test_host_experiments_equal_reference(name):
    drv, ref = {"table1": (paper.table1, _ref_table1()),
                "latency": (paper.latency, _ref_latency())}[name]
    res = drv.run()
    assert res == ref
    lines = drv.csv_lines(res)
    if name == "table1":
        want = [f"table1_{q}_red_N{r['N']},0,{r[q + '_red_model']:.4f}"
                for r in ref["rows"] for q in ("area", "power")]
    else:
        want = [f"latency_N{n}_{m},0,{r['speedup']:.4f}"
                for n, row in ref.items() for m, r in row.items()]
    assert lines == want


def test_figure_csv_names_are_the_reference_scripts():
    fig5 = {"fp32_acc": 0.5, "per_width": {
        "16": {"acc": 0.1, "power_w": 1.0}, "48": {"acc": 0.2,
                                                   "power_w": 2.0}}}
    assert [ln.split(",")[0] for ln in paper.fig5.csv_lines(fig5)] == [
        "fig5_fp32_acc", "fig5_acc_width16", "fig5_power_width16",
        "fig5_acc_width48", "fig5_power_width48"]
    fig6 = {"rmse_random_10k": 1.0, "rmse_anneal_3k": 0.5,
            "binary_search": {"found_width": 40},
            "rmse_vs_width": {"16": 3.0, "128": 0.1}}
    assert [ln.split(",")[0] for ln in paper.fig6.csv_lines(fig6)] == [
        "fig6_rmse_random10k", "fig6_rmse_anneal3k",
        "fig6_binary_search_width", "fig6_rmse_width16",
        "fig6_rmse_width128"]
    fig7 = {"task_specific_width": 31, "power_task_w": 1.0,
            "area_task_mm2": 2.0}
    assert paper.fig7.csv_lines(fig7) == [
        "fig7_task_width,0,31", "fig7_power_task_w,0,1.000",
        "fig7_area_task_mm2,0,2.000"]
    assert [d.name for d in paper.EXPERIMENTS] == [
        "table1_hw", "latency_throughput", "fig6_rmse", "fig7_taskspecific",
        "table2_accuracy", "fig5_bitwidth"]


@pytest.mark.parametrize("only", ["table1", "latency"])
def test_cli_prints_csv_rows(only, capsys):
    paper.main(["--only", only, "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    drv = paper.table1 if only == "table1" else paper.latency
    assert out[:2] == ["name,us_per_call,derived", "device,0,cpu"]
    assert out[2:-1] == drv.csv_lines(drv.run())
    assert out[-1].startswith(f"{drv.name}_wall_s,")
