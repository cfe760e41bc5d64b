"""The benchmark of ``repro_torch``'s embedding-reduction server.

Run from the root of a checkout::

    python3 recbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs one CUDA card (the cells ask for one), and exits with code 1 and
prints no result without it.  With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
under the profiler and from the program's own spans and counters.  The
last line of standard output is the result, one JSON object; the last
lines of standard error give each number the check compared, beside its
limit.  The program comes from ``src/`` of the
checkout, its kernels are built into ``build/`` there.

The process runs on the highest :data:`HOST_CPUS` CPUs of its affinity
mask, with one intra-op thread (``OMP_NUM_THREADS=1``): room for host
threads the program makes itself, and no idle pool spinning beside them.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: CPUs the process runs on
HOST_CPUS = 4


def forbidden_modules(modules=None) -> list[str]:
    """The top-level names in :data:`FORBIDDEN` of ``modules`` (module
    names; the loaded modules by default), each compared whole."""
    names = list(sys.modules) if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_reader(root: Path, name: str):
    """The reader of metric ``name``: ``recbench/metrics/<name>.py``."""
    path = root / "recbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "recbench_metric_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_metrics(root: Path, bench: dict, workload: str, run: dict, traced: bool) -> dict:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones; a reader that finds nothing to read leaves its metric out."""
    out = {}
    for m in bench["per_layer" if traced else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = load_reader(root, m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(root: Path, cell, seed: int, seconds: float, traced: bool, device: str,
            t_process: float, dtype=None) -> tuple[dict, dict]:
    """Runs ``cell`` (a :class:`recbench.harness.Cell`) and returns its
    result line and what the run recorded: everything of a run but the
    device check and the module check."""
    import torch

    from recbench import harness, reference

    run = harness.run_cell(cell, seed, seconds, traced, device, t_process,
                           dtype=dtype or torch.float32)
    limits = cell.config["limits"]
    readings = run["readings"]
    correct = run["attempted"] > 0 and reference.judge(readings, limits)
    dev = torch.device(device)
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1, "memory_peak_bytes": run["memory_peak_bytes"]}
    line = {"correct": bool(correct), "attempted": run["attempted"], "failed": run["failed"],
            "metrics": read_metrics(root, cell.bench, cell.name, run, traced), "device": info}
    trace = run["trace"]
    if trace is not None:
        info["busy_s"] = trace.busy_s()
        info["window_s"] = trace.window_s
        line["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    line["footprint"] = {k: run[k] for k in ("server_bytes", "image_bytes", "window_peak_bytes")}
    line["host"] = {"cpus": sorted(os.sched_getaffinity(0)), "plan_build_s": run["plan_build_s"]}
    line["checks"] = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    return line, run


def host_cpus(mask) -> set[int]:
    """The highest :data:`HOST_CPUS` CPUs of ``mask``, all where it has fewer."""
    return set(sorted(mask)[-HOST_CPUS:])


def prepare_process() -> None:
    """Sets up this process before PyTorch is imported: the program's
    validators off, its kernel caches inside the checkout, and the CPUs and
    threads of the module's docstring.  With PyTorch's default pool its
    idle threads spin on every CPU, and on the card's shared host the runs
    spread 3× as widely (PERF.md §4)."""
    os.environ["RECROSS_VALIDATE"] = "0"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["OMP_NUM_THREADS"] = "1"
    os.sched_setaffinity(0, host_cpus(os.sched_getaffinity(0)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    prepare_process()

    import torch

    from recbench import harness

    cell = harness.resolve(ROOT, args.workload)
    chips = next(w["chips"] for w in cell.bench["workloads"] if w["name"] == cell.name)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    line, run = execute(ROOT, cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark forbids: {found}", file=sys.stderr)
        return 1
    print(f"setup_s {run['setup_s']!r} window_s {run['window_s']!r} "
          f"memory_peak_bytes {run['memory_peak_bytes']} footprint {line['footprint']} "
          f"host {line['host']}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
