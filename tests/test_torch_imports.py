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
import repro_torch.serve
serve_pulls_decode = "repro_torch.serve.decode" in sys.modules
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # module level only: main() is not run
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": mods, "bad": bad, "serve_pulls_decode": serve_pulls_decode}))
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
    assert res["serve_pulls_decode"] is False
    for mod in ("repro_torch.serve.sharded", "repro_torch.kernels.crossbar_reduce",
                "repro_torch.launch.serve_sharded", "repro_torch.convert",
                "repro_torch.kernels.embedding_bag", "repro_torch.core.energy",
                "repro_torch.core.dynamic_switch", "repro_torch.core.simulator",
                "repro_torch.core.baselines", "repro_torch.models.layers",
                "repro_torch.models.dlrm", "repro_torch.configs.dlrm_recross",
                "repro_torch.launch.train_dlrm", "repro_torch.configs.base",
                "repro_torch.configs.chatglm3_6b", "repro_torch.configs.stablelm_3b",
                "repro_torch.models.rope", "repro_torch.models.attention",
                "repro_torch.models.transformer", "repro_torch.kernels.decode_attention",
                "repro_torch.serve.kvcache", "repro_torch.serve.decode",
                "repro_torch.serve.batching", "repro_torch.launch.serve",
                "repro_torch.serve.scheduler", "repro_torch.serve.producers",
                "repro_torch.serve.faults", "repro_torch.serve.drift",
                "repro_torch.dist.replan", "repro_torch.serve.tiers",
                "repro_torch.dist.mesh", "repro_torch.analysis",
                "repro_torch.analysis.__main__", "repro_torch.launch.quickstart",
                "repro_torch.data.pipeline", "repro_torch.train",
                "repro_torch.train.optimizer", "repro_torch.train.loop",
                "repro_torch.train.checkpoint", "repro_torch.train.compression",
                "repro_torch.train.fault_tolerance", "repro_torch.train.tree",
                "repro_torch.launch.train", "repro_torch.models.moe",
                "repro_torch.configs.granite_moe_3b_a800m", "repro_torch.configs.grok_1_314b",
                "repro_torch.configs.minicpm_2b", "repro_torch.configs.command_r_35b",
                "repro_torch.configs.llama_3_2_vision_11b",
                "repro_torch.configs.musicgen_medium", "repro_torch.models.xlstm",
                "repro_torch.models.mamba2", "repro_torch.configs.xlstm_125m",
                "repro_torch.configs.zamba2_7b", "repro_torch.dist.sharding",
                "repro_torch.dist.pipeline_parallel", "repro_torch.launch.mesh",
                "repro_torch.launch.dryrun", "repro_torch.launch.elastic_restart",
                "repro_torch.launch.mesh_comms", "repro_torch.launch.analytic",
                "repro_torch.launch.roofline", "repro_torch.launch.report",
                "repro_torch.core.trace"):
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


def test_ops_reexports_the_reference_oracles():
    """``kernels.ops`` re-exports the plain versions the reference's
    ``ops`` re-exports (``src/repro/kernels/ops.py:136-138``)."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops, ref

    for name in ("crossbar_reduce_ref", "crossbar_reduce_blocked_ref", "embedding_bag_ref"):
        assert hasattr(jops, name)
        assert getattr(ops, name) is getattr(ref, name)
