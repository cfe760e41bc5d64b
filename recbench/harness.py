"""One run of one cell: set-up, the measured window, the check.

Everything a cell is made of is found by name.  ``BENCHMARK.json`` names
the cell's configuration (its ``file``, under ``recbench/configs/``) and its
traffic mix (``recbench/traffic/<traffic>.json``).  The configuration
gives the tables, the server's settings, the seeds of the catalogue and
the history, and the limits of the check; the mix gives the traffic's
parameters (see :mod:`recbench.generator`).

A configuration gives its tables in one of two forms (:func:`tables_of`):

* ``"tables": [{"rows": R, "bag": b, "law": "fixed" | "poisson"}, ...]``,
  one entry a table, each with its own rows and bag law;
* ``"tables": N`` with ``"rows"`` and ``"mean_bag"``: ``N`` identical
  ``"poisson"`` tables.

Table ``t`` is named ``t{t}``; its catalogue is seeded
``[catalogue_seed, t]`` and its history ``[history_seed, t]``.  Every other
key (``embed_dim``, ``padded_dim``, ``server``, ``history_queries``,
``limits``) holds for all the tables.

A run:

1. makes the tables on the device from ``--seed`` (random normal values
   in the logical columns, zeros in the padding columns the kernel's
   width rule asks for) and the catalogue and plan history from the
   configuration's fixed seeds;
2. builds the server (its plan and image) and warms it up with requests
   of the cell's own shape; in a traced run the program's own spans and
   counters (``repro_torch.core.trace``) are on from here, and their
   totals are read after the build and at the window's ends;
3. for ``seconds`` issues requests back to back from one client (a closed
   loop): each maps every table to ``samples_per_request`` bags and is
   done when its results are complete on the device;
4. after the window reads the peak memory, frees the server, and holds
   every row that every request returned against the plain reference
   (:mod:`recbench.reference`), whose copy of the tables waited on the
   host through the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from recbench import generator, reference, trace as tracing, work

WARMUP_REQUESTS = 4
#: failed requests whose traceback is printed
_SHOWN_FAILURES = 3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A cell as ``BENCHMARK.json`` names it, with its files read."""

    name: str
    config: dict
    mix: dict
    bench: dict


def resolve(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, its configuration
    and its traffic mix."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({sorted(cells)})")
    w = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(workload, load_json(root / config["file"]),
                load_json(root / "recbench" / "traffic" / f"{w['traffic']}.json"), bench)


@dataclasses.dataclass(frozen=True)
class Table:
    """One table of a configuration: its rows and its bag law."""

    name: str
    rows: int
    bag: float
    law: str


def tables_of(config: dict) -> list[Table]:
    """The configuration's tables, in order (the two forms of the module's
    docstring).  Raises ``ValueError`` on an entry it cannot serve."""
    spec = config["tables"]
    if isinstance(spec, int):
        spec = [{"rows": config["rows"], "bag": config["mean_bag"], "law": "poisson"}] * spec
    if not isinstance(spec, list) or not spec:
        raise ValueError(f"tables must be a count or a non-empty list, not {spec!r}")
    out = []
    for t, entry in enumerate(spec):
        if not isinstance(entry, dict) or set(entry) != {"rows", "bag", "law"}:
            raise ValueError(f"table {t}: {entry!r} is not {{rows, bag, law}}")
        rows, bag, law = entry["rows"], entry["bag"], entry["law"]
        if law not in generator.LAWS:
            raise ValueError(f"table {t}: bag law {law!r} not in {generator.LAWS}")
        if not isinstance(rows, int) or rows < 1 or not bag >= 1:
            raise ValueError(f"table {t}: needs rows and bag of at least 1, has {entry!r}")
        if law == "fixed" and bag != int(bag):
            raise ValueError(f"table {t}: a fixed bag is a whole number, not {bag!r}")
        out.append(Table(f"t{t}", rows, float(bag), law))
    return out


def make_tables(config: dict, seed: int, device: torch.device) -> list[torch.Tensor]:
    """One ``(rows, padded_dim)`` float32 tensor a table on ``device``, from
    ``seed``: normal values in the first ``embed_dim`` columns, zeros after
    them.  A configuration of identical tables (``"tables": N``) draws them
    all in one call from one generator, as it always has; one that lists its
    tables draws each from its own generator, seeded ``[seed, t]``, one table
    at a time."""
    dim, width = config["embed_dim"], config["padded_dim"]
    tables = tables_of(config)
    gen = torch.Generator(device=device)
    if not isinstance(config["tables"], list):
        gen.manual_seed(seed)
        full = torch.zeros((len(tables), tables[0].rows, width), dtype=torch.float32,
                           device=device)
        full[:, :, :dim].normal_(generator=gen)
        return list(full.unbind(0))
    out = []
    for t, table in enumerate(tables):
        gen.manual_seed(generator.seed_of([seed, t]))
        values = torch.zeros((table.rows, width), dtype=torch.float32, device=device)
        values[:, :dim].normal_(generator=gen)
        out.append(values)
    return out


def make_traffic(config: dict, mix: dict):
    """Each table's catalogue and plan history, from the configuration's seeds."""
    catalogues, histories = {}, {}
    for t, table in enumerate(tables_of(config)):
        name = table.name
        cat = generator.make_catalogue(table.rows, table.bag, mix,
                                       [config["catalogue_seed"], t], table.law)
        catalogues[name] = cat
        histories[name] = generator.draw_bags(
            cat, np.random.default_rng([config["history_seed"], t]), config["history_queries"])
    return catalogues, histories


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _span(traced: bool, name: str):
    """A profiler span named ``name`` in a traced run, else nothing."""
    return torch.profiler.record_function(name) if traced else contextlib.nullcontext()


def _peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def _program_trace(on: bool):
    """The program's spans and counters (``repro_torch.core.trace``): on and
    cleared for a traced run, off for any other; as they were after it."""
    from repro_torch.core import trace

    was = trace.enabled()
    trace.set_enabled(on)
    if on:
        trace.reset()
    try:
        yield trace
    finally:
        trace.set_enabled(was)


def _difference(a: dict, b: dict) -> dict:
    """Totals ``b`` less totals ``a`` (:func:`repro_torch.core.trace.totals`),
    by span (``[seconds, calls]``, spans that ran between them) and by
    counter."""
    spans = {}
    for name, (seconds, calls) in b["spans"].items():
        s0, c0 = a["spans"].get(name, (0.0, 0))
        if calls > c0:
            spans[name] = [seconds - s0, calls - c0]
    return {"spans": spans,
            "counters": {k: v - a["counters"].get(k, 0) for k, v in b["counters"].items()}}


def _counters(server) -> dict:
    """The program's own counters: host compile seconds and kernel launches."""
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda

    serve = server.report().get("serve", {})
    return {"host_compile_s": serve.get("host_compile_s"),
            "launches": getattr(crossbar_reduce_cuda, "launches", None)}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_process: float, dtype: torch.dtype = torch.float32) -> dict:
    """Runs ``cell`` once and returns what the metrics and the check read.

    ``t_process`` is the host clock when the process started; ``dtype`` is
    the type the tables are served in (the control serves bfloat16; the
    reference always reads the float32 tables).
    """
    from repro_torch.serve.sharded import ShardedEmbeddingServer

    device = torch.device(device)
    config, mix = cell.config, cell.mix
    names = [t.name for t in tables_of(config)]
    width = config["padded_dim"]
    full = make_tables(config, seed, device)
    catalogues, histories = make_traffic(config, mix)
    served = {n: (x if dtype == torch.float32 else x.to(dtype)) for n, x in zip(names, full)}

    with _program_trace(traced) as program:
        t0 = time.perf_counter()
        server = ShardedEmbeddingServer(served, histories, device=device, **config["server"])
        _sync(device)
        plan_build_s = time.perf_counter() - t0
        plan_totals = program.totals() if traced else None
        # the reference's copy of the logical columns waits on the host: the
        # window holds only what the server holds
        logical = [x[:, :config["embed_dim"]].cpu() for x in full]
        del served, histories, full
        _free(device)

        samples = mix["samples_per_request"]
        warm = generator.Stream(catalogues, samples, (seed, 2), device)
        times = []
        for i in range(WARMUP_REQUESTS):
            t0 = time.perf_counter()
            server.serve(warm[i])
            _sync(device)
            times.append(time.perf_counter() - t0)
        # enough requests for the window, drawn before it opens; more are
        # drawn inside it only if the server outruns this estimate
        stream = generator.Stream(catalogues, samples, (seed, 1), device)
        stream.extend(int(2 * seconds / max(min(times), 1e-4)) + 1)
        setup_peak = _peak(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        prof = tracing.start(device) if traced else None
        before = _counters(server)
        open_totals = program.totals() if traced else None
        outputs, latencies = [], []
        failures = 0
        with _span(traced, tracing.WINDOW):
            t_open = time.perf_counter()
            setup_s = t_open - t_process
            t_close = t_open + seconds
            while time.perf_counter() < t_close:
                request = stream[len(outputs)]
                t0 = time.perf_counter()
                try:
                    out = server.serve(request)
                    _sync(device)
                except Exception:  # a failed request is counted and the loop goes on
                    failures += 1
                    if failures <= _SHOWN_FAILURES:
                        traceback.print_exc(file=sys.stderr)
                    out = None
                latencies.append(time.perf_counter() - t0)
                outputs.append(out)
            window_s = time.perf_counter() - t_open
        program_run = None
        if traced:
            program_run = {"plan": plan_totals,
                           "window": _difference(open_totals, program.totals())}
        device_trace = (tracing.stop(prof, program_run["window"]["spans"])
                        if prof is not None else None)
    after = _counters(server)
    window_peak = _peak(device)
    server_bytes = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    image_bytes = server.report().get("image_bytes")
    server.close()
    del server
    _free(device)

    requests = stream.requests[:len(outputs)]
    tables = {n: table.to(device) for n, table in zip(names, logical)}
    del logical
    readings = reference.compare(tables, requests, outputs, width)
    ok = [reference.served_ok(o, r, width) for o, r in zip(outputs, requests)]
    least = None
    if traced:
        least = sum(work.least_time_s(*work.request_work(r, config["embed_dim"], "float32"),
                                      "float32") for r in requests)
    return {
        "setup_s": setup_s, "plan_build_s": plan_build_s, "window_s": window_s,
        "attempted": len(outputs), "failed": len(outputs) - sum(ok),
        "latencies_s": [t if good else math.inf for t, good in zip(latencies, ok)],
        "samples": samples * sum(ok), "counters": (before, after),
        "memory_peak_bytes": max(setup_peak, window_peak), "window_peak_bytes": window_peak,
        "server_bytes": int(server_bytes), "image_bytes": image_bytes,
        "trace": device_trace, "least_time_s": least, "readings": readings,
        "program": program_run,
    }
