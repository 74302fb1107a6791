"""The port stands alone: importing every module of ``repro_torch`` (and
``chip_smoke.py``) pulls in neither JAX nor the JAX package, and
``chip_smoke.py`` refuses to run without a card."""
import json
import os
import pkgutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
from repro_torch.configs import get_config
from repro_torch.models import init_cache, supports_ragged_mask  # noqa: F401
from repro_torch.serve import ServeEngine, generate  # noqa: F401
from repro_torch.serve.telemetry import ServeTelemetry  # noqa: F401
from repro_torch.obs import DriftMonitor  # noqa: F401
from repro_torch.analysis.ledger import attach_ledger  # noqa: F401
for arch in ("qwen1.5-4b", "starcoder2-3b", "gemma2-27b",
             "qwen3-moe-235b-a22b", "deepseek-v3-671b",
             "phi-3-vision-4.2b", "hymba-1.5b", "xlstm-1.3b",
             "whisper-large-v3"):
    get_config(arch)
from repro_torch.models import input_specs, mtp_logits, runnable  # noqa
from repro_torch.nn.moe import moe_apply  # noqa: F401
from repro_torch.nn.mla import mla_apply  # noqa: F401
from repro_torch.nn.ssm import ssm_apply  # noqa: F401
from repro_torch.nn.blocks import hybrid_block_apply  # noqa: F401
from repro_torch.nn.xlstm import mlstm_apply, slstm_apply  # noqa: F401
from repro_torch.nn.blocks import (mlstm_block_apply,  # noqa: F401
                                   xattn_decoder_block_apply)
from repro_torch.models.encdec import apply_encdec, encode  # noqa: F401
from repro_torch.parallel.mesh import Mesh, run_ranks, set_mesh  # noqa: F401
from repro_torch.parallel.sharding import shard_params  # noqa: F401
from repro_torch.apps.paper import EXPERIMENTS  # noqa: F401
from repro_torch.apps.image_cls import params_from_jax  # noqa: F401
from repro_torch.hw import mac_array_cost, simulate_latency  # noqa: F401
sys.path.insert(0, sys.argv[1])
import chip_smoke  # noqa: F401  (module import only: main() is not run)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    return env


def test_no_jax_or_reference_imports():
    res = subprocess.run([sys.executable, "-c", _PROBE, ROOT], env=_env(),
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    # every subpackage of the port was imported
    for sub in ("configs", "core", "kernels", "models", "nn", "quant",
                "serve", "data", "launch", "ckpt", "parallel", "obs",
                "analysis", "optim", "train", "apps", "hw"):
        assert f"repro_torch.{sub}" in out["modules"]
    for mod in ("launch.serve", "kernels.flash_attention",
                "kernels.paged_attention", "quant.kvcache", "nn.paged",
                "core.search", "ckpt.checkpoint", "parallel.sharding",
                "parallel.mesh",
                "serve.spec", "serve.graphs", "configs.qwen15_4b",
                "configs.starcoder2_3b", "configs.gemma2_27b",
                "obs.stats", "obs.metrics", "obs.trace", "obs.jitcount",
                "obs.drift", "obs.profile", "analysis.ledger",
                "serve.telemetry", "launch.env", "nn.moe", "nn.mla",
                "nn.blocks", "models.registry", "configs.qwen3_moe_235b",
                "configs.deepseek_v3_671b", "nn.ssm",
                "configs.phi3_vision_4p2b", "configs.hymba_1p5b",
                "nn.xlstm", "models.encdec", "configs.xlstm_1p3b",
                "configs.whisper_large_v3", "quant.nonuniform",
                "apps.image_cls", "apps.paper", "hw.costmodel",
                "hw.systolic"):
        assert f"repro_torch.{mod}" in out["modules"]


TRAINING = ("repro_torch.optim", "repro_torch.optim.optimizers",
            "repro_torch.optim.schedule", "repro_torch.optim.clip",
            "repro_torch.optim.compression", "repro_torch.train",
            "repro_torch.train.trainer", "repro_torch.train.losses",
            "repro_torch.data.pipeline", "repro_torch.launch.train",
            "repro_torch.tree")

_PROBE_TRAINING = r"""
import importlib, json, sys
for n in sys.argv[1:]:
    importlib.import_module(n)
from repro_torch.train import init_train_state, make_train_step  # noqa
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"bad": bad}))
"""


def test_training_modules_import_no_jax():
    """The trainer's modules, imported alone in a fresh process, pull in
    neither JAX nor the JAX package."""
    res = subprocess.run([sys.executable, "-c", _PROBE_TRAINING, *TRAINING],
                         env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1])["bad"] == []


def test_every_module_is_walked():
    import repro_torch
    found = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    on_disk = set()
    for dirpath, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        rel = os.path.relpath(dirpath, SRC).replace(os.sep, ".")
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                on_disk.add(f"{rel}.{f[:-3]}")
    assert on_disk <= found


def test_chip_smoke_fails_without_a_card():
    """No CUDA → non-zero exit and no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=240)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
