"""The port's static analysis (``repro_torch.analysis``) on the CPU: the
tree is clean under the lint rules, the kernel-plan check and the
sharding check; each seeded defect is caught; suppressions round-trip;
the runner exits 0 on the tree and 1 on a planted finding; the roofline
module gives ``PERF.md``'s bounds; the dry run's bytes a rank are the
real tree's.  Case names follow ``tests/test_analysis.py`` where a case
has a counterpart there."""
import ctypes
import os
import re
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


@pytest.fixture(scope="module")
def kernel_report():
    from repro_torch.analysis.kernelcheck import run_kernelcheck
    return run_kernelcheck()


@pytest.fixture(scope="module")
def shard_report():
    from repro_torch.analysis.shardcheck import run_shardcheck
    return run_shardcheck()


# ---------------------------------------------------------------------------
# lint: clean tree, suppression round trip, rule registry
# ---------------------------------------------------------------------------

def test_lint_tree_is_clean():
    from repro_torch.analysis.lint import repo_root, run_lint
    assert [str(f) for f in run_lint(root=repo_root())] == []


def test_rule_registry_names_the_documented_rules():
    from repro_torch.analysis.lint import registered_rules
    rules = registered_rules()
    assert set(rules) == {"host-sync-in-hot-path", "jit-in-loop",
                          "f32-accum", "metric-docs-sync"}
    assert rules["host-sync-in-hot-path"].allow == "host-sync"


def test_suppression_round_trip():
    from repro_torch.analysis.selftest import (_lint_annotation_honored,
                                               _lint_blanket_rejected,
                                               _lint_hot_sync_caught)
    assert _lint_hot_sync_caught()       # unannotated sync → finding
    assert _lint_annotation_honored()    # reasoned allow() → suppressed
    assert _lint_blanket_rejected()      # reasonless allow() → finding


def test_metric_docs_sync_round_trip():
    from repro_torch.analysis.selftest import _metric_docs_drift
    assert _metric_docs_drift()


def test_hot_path_syncs_are_annotated():
    """Every sync the serving loops reach carries its reason: the rule
    finds them (so it sees the loop) and the annotations waive them."""
    from repro_torch.analysis.lint import Repo, repo_root
    from repro_torch.analysis.rules import hostsync
    repo = Repo(repo_root())
    raw = hostsync.check(repo)
    sites = {(f.file.rsplit("/", 1)[-1], f.message.split(" in ")[1]
              .split(":")[0]) for f in raw}
    assert ("engine.py", "Engine._step_impl") in sites
    assert ("engine.py", "Engine._spec_round") in sites
    assert ("engine.py", "Engine._sync") in sites
    assert ("engine.py", "ServeEngine._run") in sites
    assert ("drift.py", "logit_agreement") in sites    # self.tel.drift.…
    for f in raw:
        sup = repo.suppressions(repo.lines_of(f.file))
        assert "host-sync" in sup.get(f.line, set()), str(f)


def test_nested_attribute_sync_is_caught():
    """A sync reached through ``self.tel.monitor.sample`` (types from a
    parameter's annotation and a classmethod's return) is found."""
    from repro_torch.analysis.selftest import _lint_nested_attribute_sync
    assert _lint_nested_attribute_sync()


def test_f32_accum_reads_every_mma_and_plain_product():
    from repro_torch.analysis.lint import Repo, repo_root
    from repro_torch.analysis.rules import f32accum
    repo = Repo(repo_root())
    n_mma = sum(len(f32accum.MMA_LITERAL_RE.findall(line))
                for src in repo.csrc.values() for line in src.lines)
    assert n_mma >= 3                     # encoded_matmul, flash x 2
    names = {fn.name for _, fn in f32accum.plain_functions(repo)}
    assert {"encoded_matmul_plain", "paged_attn_plain",
            "flash_attention_plain", "encoded_matmul_ref"} <= names
    assert f32accum.check(repo) == []


def test_f32_accum_catches_a_bf16_product(tmp_path):
    from repro_torch.analysis.lint import Repo
    from repro_torch.analysis.rules import f32accum
    pkg = tmp_path / "src" / "repro_torch" / "kernels"
    pkg.mkdir(parents=True)
    (pkg.parent / "__init__.py").write_text("")
    (pkg / "__init__.py").write_text("")
    (pkg / "k.py").write_text(
        "import torch\n\n"
        "def k_plain(a, w):\n"
        "    f32 = torch.float32\n"
        "    x = a.to(torch.bfloat16)\n"
        "    return torch.einsum('mk,kn->mn', x, w.to(f32))\n")
    f = f32accum.check(Repo(str(tmp_path)))
    assert len(f) == 1 and "operand 0" in f[0].message


def test_capture_in_loop_is_caught():
    from repro_torch.analysis.selftest import _capture_in_loop
    assert _capture_in_loop()


# ---------------------------------------------------------------------------
# kernel plans: real plans sound, seeded defects caught
# ---------------------------------------------------------------------------

def test_real_plans_are_sound(kernel_report):
    findings, cov = kernel_report
    assert [str(f) for f in findings] == []
    assert cov["kernel1"]["plans"] > 100_000
    assert cov["kernel2"]["geometries"] > 100_000
    assert 132 in cov["kernel1"]["sms"]


def test_kernelcheck_covers_the_gated_geometries(kernel_report):
    """Every (k, n) that chip_smoke.py's phase 3 gates (each arch, TP 1
    and 2) is a checked linear shape, every U up to MAX_MONOS and every
    tile of m; every kv-head count of phase 4 is checked."""
    import importlib
    from repro_torch.analysis.kernelcheck import (M_VALUES, linear_shapes,
                                                  paged_heads)
    from repro_torch.analysis.shardcheck import serving_refusal
    from repro_torch.configs import get_config, list_archs
    from repro_torch.kernels.encoded_matmul import MAX_MONOS, tile_n
    sys.path.insert(0, ROOT)
    try:
        smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)
    shapes = set(linear_shapes())
    for arch in list_archs():
        cfg = get_config(arch)
        for tp in (1, 2):
            if tp == 2 and serving_refusal(cfg) is not None:
                continue
            for decode in (False, True):
                want = set(smoke._linear_shapes(cfg, decode, tp))
                assert want <= shapes, (arch, tp, want - shapes)
    assert {tile_n(m) for m in M_VALUES} == {8, 16, 32}
    _, cov = kernel_report
    assert cov["kernel1"]["U"] == [1, MAX_MONOS]
    assert {16, 8, 4, 2} <= set(paged_heads())      # phase 4: 16/16, 64/4


def test_off_by_one_chunk_run_is_caught():
    from repro_torch.analysis.selftest import _kernel_chunk_off_by_one
    assert _kernel_chunk_off_by_one()


def test_page_past_pages_used_is_caught():
    from repro_torch.analysis.selftest import _kernel_page_past_used
    assert _kernel_page_past_used()


def test_cluster_from_lens_is_caught():
    from repro_torch.analysis.kernelcheck import check_cluster_call_sites
    from repro_torch.analysis.selftest import _kernel_cluster_from_lens
    assert _kernel_cluster_from_lens()
    assert check_cluster_call_sites() == []
    bad = "cl = cluster_size(B, Hkv, int(lens.max()) // ps + 1, sms)\n"
    assert check_cluster_call_sites(bad)


def test_constants_and_abi_clean_and_catch_a_changed_entry(kernel_report):
    from repro_torch.analysis.kernelcheck import (MIRRORS, LAUNCHERS,
                                                  PA_REL, check_abi,
                                                  check_constants)
    from repro_torch.kernels import paged_attention as pa
    _, cov = kernel_report
    assert len(cov["constants"]) == len(MIRRORS)
    assert all(r["ok"] for r in cov["constants"])
    assert len(cov["launchers"]) == len(LAUNCHERS)
    assert all(r["ok"] for r in cov["launchers"])
    f, _ = check_constants(values={(PA_REL, "MAX_CLUSTER"): 16})
    assert any("MAX_CLUSTER" in x.message for x in f)
    short = tuple(pa.ARGTYPES[:-1])                  # the stream dropped
    f, _ = check_abi(argtypes={(PA_REL, "ARGTYPES"): short})
    assert any("has 23 entries" in x.message for x in f)
    swapped = list(pa.ARGTYPES)
    swapped[19] = ctypes.c_int                       # scale, a float
    f, _ = check_abi(argtypes={(PA_REL, "ARGTYPES"): tuple(swapped)})
    assert any("ARGTYPES[19] is int" in x.message for x in f)


def test_unparsable_cu_is_a_finding():
    from repro_torch.analysis.kernelcheck import check_abi, check_constants
    f, _ = check_constants(sources={"encoded_matmul.cu": "// no constants"})
    assert any("not found or does not parse" in x.message for x in f)
    f, _ = check_abi(sources={"flash_attention.cu": "// nothing"})
    assert any("flash_attention_launch" in x.message for x in f)


# ---------------------------------------------------------------------------
# sharding coverage
# ---------------------------------------------------------------------------

def test_param_and_cache_coverage_clean(shard_report):
    findings, cov = shard_report
    assert [str(f) for f in findings] == []
    assert "qwen1.5-0.5b" in cov["served"]
    assert "qwen3-moe-235b-a22b" in cov["trained"]
    assert "deepseek-v3-671b" in cov["served"]        # MLA
    assert "deepseek-v3-671b (training)" in cov["refused"]
    assert "hymba-1.5b" in cov["refused"]             # not a finding


def test_unruled_large_leaf_is_caught():
    from repro_torch.analysis.selftest import _shard_unruled_leaf
    assert _shard_unruled_leaf()


def test_fold_role_flip_is_caught():
    from repro_torch.analysis.selftest import _shard_fold_role_flip
    assert _shard_fold_role_flip()


# ---------------------------------------------------------------------------
# self-test harness + runner
# ---------------------------------------------------------------------------

def test_selftest_has_no_escapes():
    from repro_torch.analysis.selftest import CASES, run_selftest
    results = run_selftest()
    assert len(results) == len(CASES) == 20
    assert [r for r in results if not r["caught"]] == []


def _runner(args, src=SRC, timeout=300):
    env = dict(os.environ, PYTHONPATH=src)
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True, env=env,
                          timeout=timeout)


def test_analyze_cli_lint_exits_clean(tmp_path):
    out = tmp_path / "report.json"
    r = _runner(["--lint", "--json", str(out)])
    assert r.returncode == 0, r.stdout + r.stderr
    assert out.exists()
    assert "analysis: 0 finding(s)" in r.stdout


def test_runner_exits_1_on_a_planted_finding(tmp_path):
    """A copy of the tree with an unannotated ``.item()`` in
    ``Engine.step``: the runner names it and exits 1."""
    shutil.copytree(os.path.join(SRC, "repro_torch"),
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__",
                                                  "artifacts"))
    (tmp_path / "docs").mkdir()
    shutil.copy(os.path.join(ROOT, "docs", "observability.md"),
                tmp_path / "docs")
    shutil.copy(os.path.join(ROOT, "README.md"), tmp_path)
    eng = tmp_path / "src" / "repro_torch" / "serve" / "engine.py"
    text = eng.read_text()
    anchor = "        tr = self.tel.tracer\n        t0 = time.perf_counter()\n"
    assert text.count(anchor) == 1
    planted = "        self._planted = self.kv.lens.sum().item()\n"
    eng.write_text(text.replace(anchor, anchor + planted))
    r = _runner(["--lint"], src=str(tmp_path / "src"))
    assert r.returncode == 1, r.stdout + r.stderr
    assert "[host-sync-in-hot-path] .item() in Engine.step" in r.stdout


# ---------------------------------------------------------------------------
# the roofline and the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (reckoner args, bound ms as PERF.md §6 lists it, bound by)
    (("em", 884, 2816, 1024, 8), 0.0412, "operations"),
    (("em", 360, 2816, 1024, 8), 0.0168, "operations"),
    (("em", 4, 2816, 1024, 8), 0.0138, "bytes"),
    (("em", 32, 1024, 2816, 8), 0.0139, "bytes"),
    (("pa", 1, 16, 16, 64), 0.0026, "bytes"),
    (("pa", 9, 16, 16, 64), 0.0027, "bytes"),
    (("pa", 9, 64, 4, 128), 0.0047, "operations"),
    (("flash", 4), 0.0521, "operations"),
    (("flash", 2), 0.0100, "bytes"),
], ids=lambda c: "-".join(map(str, c[0])) if isinstance(c, tuple) else c)
def test_roofline_matches_perf_md(case):
    from repro_torch.launch import roofline as R
    args, want, by = case
    if args[0] == "em":
        r = R.encoded_matmul(*args[1:])
    elif args[0] == "pa":
        sq, hq, hkv, d = args[1:]
        r = R.paged_attn(4, sq, hq, hkv, d, 16, [100, 200, 300, 400])
    else:
        r = R.flash_attention(4, 1024, 16, 64, args[1])
    assert round(r.bound_ms, 4) == want and r.bound_by == by


def test_kernel_bench_bound_is_the_roofline():
    """``launch/kernel_bench.py`` times kernel 1 at m = 884 and bounds it
    by its operations there, as chip_smoke.py's kernels line does."""
    from repro_torch.launch import kernel_bench
    assert (884, 2816, 1024) in kernel_bench.SHAPES
    r = kernel_bench.roofline().encoded_matmul(884, 2816, 1024, 8)
    assert r.bound_by == "operations" and round(r.bound_ms, 4) == 0.0412
    src = open(kernel_bench.__file__).read()
    for peak in ("3.35e12", "989e12", "495e12"):
        assert peak not in src
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert not re.search(r"^PEAK_\w+\s*=", smoke, re.M)     # no copy


def test_dryrun_params_bytes_equal_the_real_tree():
    """At reduced size the dry run's bytes a rank equal the real tree's:
    the whole params at TP 1, rank 0's ``shard_params`` slices at TP 2."""
    from repro_torch.analysis.shardcheck import LayoutMesh, leaf_paths
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import init_model
    from repro_torch.parallel.sharding import shard_params
    cfg = get_config("qwen1.5-0.5b").reduced()
    real = init_model(cfg, seed=0, device="cpu")

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for _, t in leaf_paths(tree))
    for tp in (1, 2):
        rec = dryrun.cell(cfg, SHAPES["decode_32k"], tp)
        mine = shard_params(real, cfg, LayoutMesh(tp)) if tp > 1 else real
        assert rec["params_bytes"] == nbytes(mine)
        assert rec["kv_bytes"] > 0 and rec["fits"]


def test_dryrun_sweep_writes_json(tmp_path):
    from repro_torch.launch import dryrun
    recs = list(dryrun.sweep(["qwen1.5-0.5b"], ["train_4k", "long_500k"],
                             out_dir=str(tmp_path)))
    assert len(recs) == 6
    assert all("skipped" in r for r in recs if r["shape"] == "long_500k")
    tp2 = next(r for r in recs if r["shape"] == "train_4k" and r["tp"] == 2)
    tp1 = next(r for r in recs if r["shape"] == "train_4k" and r["tp"] == 1)
    assert tp2["params_bytes"] < tp1["params_bytes"]
    assert len(list(tmp_path.glob("*.json"))) == 6
