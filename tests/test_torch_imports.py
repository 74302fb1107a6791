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
                "serve", "data", "launch"):
        assert f"repro_torch.{sub}" in out["modules"]
    for mod in ("launch.serve", "kernels.flash_attention",
                "kernels.paged_attention", "quant.kvcache", "nn.paged"):
        assert f"repro_torch.{mod}" in out["modules"]


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
