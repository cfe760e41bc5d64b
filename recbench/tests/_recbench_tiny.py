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
#: the tiny configuration that lists its tables: tables smaller than a
#: tile, a cluster and a template beside larger ones, one-hot bags beside
#: 100-hot, at width 128
TINY_TABLES = {
    "tables": [{"rows": rows, "bag": bag, "law": "fixed"}
               for rows, bag in ((3, 1), (10, 1), (63, 1), (4096, 100), (2048, 7))],
    "embed_dim": 128, "history_queries": 2000,
}
SECONDS = 0.5


def tiny_config(name: str, changes: dict) -> dict:
    """dlrm-automotive's configuration with ``changes`` and 16-row tiles."""
    config = json.loads((ROOT / "recbench/configs/dlrm-automotive.json").read_text())
    if isinstance(changes["tables"], list):
        del config["rows"], config["mean_bag"]
    config.update(name=name, **changes)
    config["server"] = dict(config["server"], group_size=16)
    return config


def make_root(base: Path, mixes: dict | None = None) -> Path:
    """A checkout-like root: the benchmark's folder (without its tests) and
    a ``BENCHMARK.json`` with the ``tiny`` and ``tiny-tables``
    configurations and one ``<config>.<mix>`` cell of each per traffic mix,
    ``mixes`` added as new traffic files: all of it data."""
    root = base / "checkout"
    shutil.copytree(ROOT / "recbench", root / "recbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, mix in (mixes or {}).items():
        (root / "recbench/traffic" / f"{name}.json").write_text(json.dumps(mix))
    traffic = sorted(p.stem for p in (root / "recbench/traffic").glob("*.json"))
    cells = []
    for name, changes in (("tiny", TINY), ("tiny-tables", TINY_TABLES)):
        (root / f"recbench/configs/{name}.json").write_text(json.dumps(tiny_config(name, changes)))
        bench["configs"].append({"name": name, "source": "tests",
                                 "file": f"recbench/configs/{name}.json",
                                 "reduced": sorted(changes), "why": "tests"})
        bench["workloads"] += [{"name": f"{name}.{t}", "config": name, "traffic": t, "chips": 1,
                                "why": "tests"} for t in traffic]
        cells += [f"{name}.{t}" for t in traffic]
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
