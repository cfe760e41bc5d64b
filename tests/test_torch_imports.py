"""The port's import rule: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro``."""

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # module level only: main() is not run
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_importing_the_port_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep + ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    for mod in ("repro_torch.serve.sharded", "repro_torch.kernels.crossbar_reduce",
                "repro_torch.launch.serve_sharded", "repro_torch.convert"):
        assert mod in res["modules"]


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_names_jax_or_repro_imports():
    jax_import = re.compile(r"\bimport\s+jax\b|\bfrom\s+jax\b")
    repro_import = re.compile(r"\b(?:from|import)\s+repro(?!_torch)\b")
    offenders = []
    for path in _sources():
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        if jax_import.search(text) or repro_import.search(text):
            offenders.append(os.path.relpath(path, ROOT))
    assert offenders == []
