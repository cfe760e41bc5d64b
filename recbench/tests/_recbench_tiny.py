"""Tiny cells for the benchmark's CPU tests.

The tests run the harness on the CPU at a tiny size, in a copy of the
benchmark's folder beside a ``BENCHMARK.json`` that adds a tiny
configuration, a traffic mix and cells of its own: a new cell is data, and
these copies show it.
"""

import json
import shutil
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
#: the tiny configuration: dlrm-automotive's settings at 2 tables of 4,096
#: rows, 16-row tiles and a 2,000-bag history
TINY = {"tables": 2, "rows": 4096, "history_queries": 2000}
SECONDS = 0.5


def make_root(base: Path, mixes: dict | None = None) -> Path:
    """A checkout-like root: the benchmark's folder (without its tests) and
    a ``BENCHMARK.json`` with a ``tiny`` configuration and one ``tiny.<mix>``
    cell per traffic mix, ``mixes`` added as new traffic files."""
    root = base / "checkout"
    shutil.copytree(ROOT / "recbench", root / "recbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "recbench/configs/dlrm-automotive.json").read_text())
    config.update(name="tiny", **TINY)
    config["server"] = dict(config["server"], group_size=16)
    (root / "recbench/configs/tiny.json").write_text(json.dumps(config))
    for name, mix in (mixes or {}).items():
        (root / "recbench/traffic" / f"{name}.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "tiny", "source": "tests", "file": "recbench/configs/tiny.json",
                             "reduced": ["tables", "rows", "history_queries"], "why": "tests"})
    traffic = sorted(p.stem for p in (root / "recbench/traffic").glob("*.json"))
    cells = [f"tiny.{t}" for t in traffic]
    bench["workloads"] += [{"name": c, "config": "tiny", "traffic": t, "chips": 1, "why": "tests"}
                           for c, t in zip(cells, traffic)]
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + cells
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_tiny(root: Path, workload: str, *, seed: int = 2**31 + 7, traced: bool = False,
             **kw):
    """One CPU run of a tiny cell: ``(result line, run record)``."""
    from recbench import harness, run

    cell = harness.resolve(root, workload)
    return run.execute(root, cell, seed, SECONDS, traced, "cpu", time.perf_counter(), **kw)
