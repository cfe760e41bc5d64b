#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Drives the port's main path — the ReCross sharded embedding server — at
the full table sizes of the ``dlrm-recross`` model and holds every CUDA
kernel of that path against its plain PyTorch version on the card.
Phases, in order; any failure propagates and the process exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); TF32 off;
2. build: ``nvcc`` builds the kernels from ``src/repro_torch/kernels/csrc``;
3. kernel parity: the crossbar kernel against its plain version, flat and
   query-blocked, f32 and bf16, dynamic switch on and off, q_block 1 and
   8, at small shapes and at R=64, D=128, q=8 over a 100k-tile image,
   with kernel and plain times (CUDA events, median) and memory bounds;
4. serving: ``ShardedEmbeddingServer(device="cuda")`` over 8 tables of
   932,019 rows (embed_dim 64 zero-padded to 128 columns, as the JAX
   DLRM kernel path pads), group_size 64, q_block 8, batch_size 256, one
   shard; histories from ``scale_trace``; ~4,096 queries through
   ``submit``/``flush``; sampled rows checked against a plain gather+sum
   on the card; the kernel's launches counted over this run;
5. flat op: ``ops.crossbar_reduce`` on one table's compiled queries
   against ``reduce_dense_oracle`` on the card.

It then prints one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line,
and as its last line ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero and
prints no result.  It imports nothing of ``jax`` or ``repro``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12            # HBM3, H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12,        # CUDA cores, no tensor cores
              "bfloat16": 989e12}      # dense tensor-core rate
TOL = {"float32": 1e-4, "bfloat16": 0.15}

NUM_TABLES = 8                         # dlrm-recross FULL
ROWS = 932_019
EMBED_DIM = 64
PADDED_DIM = 128
GROUP_SIZE = 64
Q_BLOCK = 8
BATCH_SIZE = 256
HISTORY = 100_000
STREAM_PER_TABLE = 512                 # 8 x 512 = 4,096 served queries
SAMPLE_ROWS = 256
PLAN_BUDGET_S = 180.0
DEVICE = "cuda"


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of a callable.  Before each timed call a
    1 GiB buffer is zeroed: it evicts the 50 MB L2 (the serving path
    finds its tiles cold) and keeps the card busy for ~0.3 ms while the
    host enqueues the call, so the events time the device work, not the
    host's launch overhead (the plain versions launch several kernels)."""

    def __init__(self, torch):
        self.torch = torch
        self.scrub = torch.empty(256 * 1024 * 1024, dtype=torch.float32, device=DEVICE)

    def ms(self, fn, reps: int = 15) -> float:
        torch = self.torch
        fn()  # warm-up
        times = []
        for _ in range(reps):
            self.scrub.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def work_of(torch, image, tile_ids, bitmaps):
    """Least bytes and operations of one crossbar reduction on these inputs:
    each distinct referenced tile read once, tile ids and bitmaps read once,
    the output written once; one multiply-add per active bitmap entry and
    column."""
    esize = image.element_size()
    tile_bytes = image.shape[1] * image.shape[2] * esize
    valid = tile_ids[tile_ids >= 0]
    q_block = bitmaps.shape[2] if bitmaps.ndim == 4 else 1
    out_bytes = tile_ids.shape[0] * q_block * image.shape[2] * esize
    nbytes = (
        int(torch.unique(valid).numel()) * tile_bytes
        + tile_ids.numel() * 4 + bitmaps.numel() * esize + out_bytes
    )
    flops = 2 * int((bitmaps != 0).sum().item()) * image.shape[2]
    return nbytes, flops, int(valid.numel()) * tile_bytes


def bound(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def parity(torch, timer, name, image, tile_ids, bitmaps, *, dynamic_switch=True,
           timed=True) -> dict:
    """Kernel vs plain version on the card; raises past the tolerance."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda

    plain = ref.crossbar_reduce_blocked_ref if bitmaps.ndim == 4 else ref.crossbar_reduce_ref
    out = crossbar_reduce_cuda(image, tile_ids, bitmaps, dynamic_switch=dynamic_switch)
    torch.cuda.synchronize()
    want = plain(image, tile_ids, bitmaps)
    dtype = str(image.dtype).removeprefix("torch.")
    err = float((out.float() - want.float()).abs().max().item()) if out.numel() else 0.0
    if not (out.shape == want.shape and out.dtype == image.dtype and err <= TOL[dtype]):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: shape "
            f"{tuple(out.shape)} vs {tuple(want.shape)}, max_abs_err {err} "
            f"> {TOL[dtype]}"
        )
    nbytes, flops, slot_bytes = work_of(torch, image, tile_ids, bitmaps)
    bound_ms, bound_by = bound(nbytes, flops, dtype)
    row = {"case": name, "dtype": dtype, "switch": dynamic_switch,
           "shape": [list(image.shape), list(bitmaps.shape)],
           "max_abs_err": err, "tol": TOL[dtype], "bytes": nbytes,
           "slot_bytes": slot_bytes, "flops": flops,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if timed:
        row["ms"] = timer.ms(lambda: crossbar_reduce_cuda(
            image, tile_ids, bitmaps, dynamic_switch=dynamic_switch))
        row["plain_ms"] = timer.ms(lambda: plain(image, tile_ids, bitmaps), reps=10)
        row["GB_per_s"] = nbytes / row["ms"] / 1e6
    log("parity", json.dumps(row))
    return row


def synthetic_case(torch, gen, T, R, D, nb, S, q_block, dtype, density=0.04):
    """Random image, schedules with padding slots, READ-path slots (one
    active entry) and empty slots; ``q_block=None`` gives flat bitmaps."""
    image = torch.randn((T, R, D), generator=gen, device=DEVICE).to(dtype)
    ids = torch.randint(0, T, (nb, S), generator=gen, device=DEVICE, dtype=torch.int32)
    ids[:, S - max(1, S // 8):] = -1
    lanes = (nb, S, R) if q_block is None else (nb, S, q_block, R)
    bm = (torch.rand(lanes, generator=gen, device=DEVICE) < density).to(dtype)
    bm[ids < 0] = 0
    flat = bm.reshape(nb, S, -1)
    flat[:, 0] = 0
    flat[:, 0, 5] = 1       # READ path: exactly one active entry
    flat[:, 1] = 0          # activated but empty
    return image, ids, bm


def phase_parity(torch, timer) -> None:
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for q in (None, 1, 8):
            for sw in (True, False):
                name = f"small/{'flat' if q is None else f'q{q}'}"
                case = synthetic_case(torch, gen, 512, 64, 256, 48, 24, q, dtype)
                parity(torch, timer, name, *case, dynamic_switch=sw, timed=False)
        # the main-path shape: R=64, D=128, q=8 over a 100k-tile image
        case = synthetic_case(torch, gen, 100_000, 64, 128, 64, 128, 8, dtype)
        for sw in (True, False):
            parity(torch, timer, "100k/q8", *case, dynamic_switch=sw)
        case = synthetic_case(torch, gen, 100_000, 64, 128, 256, 32, None, dtype)
        parity(torch, timer, "100k/flat", *case)
        del case
    torch.cuda.empty_cache()


def phase_serving(torch, np, timer):
    from repro_torch.convert import tables_from_numpy
    from repro_torch.core import (
        build_cooccurrence, compile_queries, concat_compiled_queries,
        correlation_aware_grouping, offset_compiled_queries,
        reduce_dense_oracle, shard_block_queries,
    )
    from repro_torch.data import scale_trace
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda
    from repro_torch.serve import ShardedEmbeddingServer

    # probe one table's plan build; cut the table count (never a width)
    # if all eight would not fit the plan budget
    t0 = time.perf_counter()
    trace0 = scale_trace(ROWS, HISTORY + STREAM_PER_TABLE, 32.0, seed=0)
    correlation_aware_grouping(build_cooccurrence(trace0[:HISTORY], ROWS), GROUP_SIZE)
    per_table_s = time.perf_counter() - t0
    num_tables = NUM_TABLES
    if per_table_s * NUM_TABLES > PLAN_BUDGET_S:
        num_tables = max(1, int(PLAN_BUDGET_S // per_table_s))
        log(f"serving: CUT num_tables {NUM_TABLES} -> {num_tables} "
            f"(one table's plan took {per_table_s:.1f} s)")
    log(f"serving: one-table plan probe {per_table_s:.2f} s")

    rng = np.random.default_rng(1234)
    names = [f"t{t}" for t in range(num_tables)]
    host_tables, histories, streams = {}, {}, {}
    for t, name in enumerate(names):
        table = np.zeros((ROWS, PADDED_DIM), dtype=np.float32)
        table[:, :EMBED_DIM] = rng.standard_normal((ROWS, EMBED_DIM), dtype=np.float32)
        host_tables[name] = table
        trace = trace0 if t == 0 else scale_trace(
            ROWS, HISTORY + STREAM_PER_TABLE, 32.0, seed=t)
        histories[name], streams[name] = trace[:HISTORY], trace[HISTORY:]
    del trace0
    tables = tables_from_numpy(host_tables, DEVICE)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server = ShardedEmbeddingServer(
        tables, histories, num_shards=1, q_block=Q_BLOCK, group_size=GROUP_SIZE,
        batch_size=BATCH_SIZE, device=DEVICE,
    )
    plan_s = time.perf_counter() - t0
    image_bytes = server.shard_images.numel() * server.shard_images.element_size()
    log(f"serving: plan build {plan_s:.2f} s for {num_tables} tables x {ROWS} rows, "
        f"image {tuple(server.shard_images.shape)} = {image_bytes} B on the card")

    order = [(names[i % num_tables], streams[names[i % num_tables]][i // num_tables])
             for i in range(num_tables * STREAM_PER_TABLE)]
    served = {n: [] for n in names}
    results = {n: [] for n in names}
    crossbar_reduce_cuda.launches = 0
    t0 = time.perf_counter()
    for name, q in order:
        served[name].append(q)
        for n, rows_out in server.submit(name, q).items():
            results[n].append(rows_out)
    for n, rows_out in server.flush().items():
        results[n].append(rows_out)
    wall = time.perf_counter() - t0
    launches = crossbar_reduce_cuda.launches
    server.close()
    rep = server.report()["serve"]
    if launches <= 0:
        raise AssertionError("serving ran no crossbar kernel launch")

    out = {n: torch.cat(results[n]) for n in names}
    for n in names:
        if out[n].shape != (len(served[n]), PADDED_DIM) or not torch.isfinite(out[n]).all():
            raise AssertionError(f"table {n}: bad output {tuple(out[n].shape)}")
    pick = np.random.default_rng(7).choice(len(order), size=SAMPLE_ROWS, replace=False)
    seen = {n: 0 for n in names}
    index = []
    for name, _ in order:
        index.append((name, seen[name]))
        seen[name] += 1
    err = 0.0
    for i in pick.tolist():
        name, k = index[i]
        want = reduce_dense_oracle(tables[name], [served[name][k]])[0]
        err = max(err, float((out[name][k] - want).abs().max().item()))
    if err > TOL["float32"]:
        raise AssertionError(f"served rows disagree with gather+sum: {err}")

    flushes = rep["batches"]
    stats = {
        "tables": num_tables, "rows": ROWS, "dim": PADDED_DIM,
        "plan_build_s": plan_s, "image_bytes": image_bytes,
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "queries": rep["queries"], "flushes": flushes, "wall_s": wall,
        "queries_per_s": rep["queries"] / wall,
        "flush_p50_ms": float(np.percentile(server.stats.flush_wall, 50)) * 1e3,
        "flush_p99_ms": float(np.percentile(server.stats.flush_wall, 99)) * 1e3,
        "host_compile_s": rep["host_compile_s"],
        "kernel_launches": launches, "launches_per_flush": launches / flushes,
        "max_shard_width": rep["max_shard_width"],
        "sampled_rows": SAMPLE_ROWS, "sample_max_abs_err": err,
    }
    log("serving", json.dumps(stats))

    # one real flush, replayed kernel-by-kernel as the server launches it
    # (chunk 0 of combine_chunks=2), for the kernel's main-path time
    batch = order[:BATCH_SIZE]
    cqs = []
    for name in names:
        qs = [q for n, q in batch if n == name]
        i = server.names.index(name)
        cqs.append(offset_compiled_queries(
            compile_queries(server.layouts[i], qs, replica_block=Q_BLOCK, device="cpu"),
            server.plan.tables[i].tile_offset))
    fused, _ = concat_compiled_queries(cqs, Q_BLOCK)
    sbq = shard_block_queries(fused, server.plan, Q_BLOCK, device=DEVICE)
    half = -(-sbq.num_blocks // 2)
    real = parity(torch, timer, "serving-flush/q8", server.shard_images[0],
                  sbq.tile_ids[0, :half].contiguous(), sbq.bitmaps[0, :half].contiguous())
    return stats, real, server, tables, streams


def phase_flat(torch, timer, server, tables, streams) -> dict:
    from repro_torch.core import compile_queries, reduce_dense_oracle
    from repro_torch.kernels import ops
    from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda

    name = server.names[0]
    layout = server.layouts[0]
    table = tables[name]
    host = table.cpu().numpy()
    image = torch.from_numpy(
        layout.build_image(host).reshape(layout.num_tiles, layout.tile_rows, PADDED_DIM)
    ).to(DEVICE)
    queries = streams[name][:BATCH_SIZE]
    cq = compile_queries(layout, queries, device=DEVICE)
    crossbar_reduce_cuda.launches = 0
    out = ops.crossbar_reduce(image, cq.tile_ids, cq.bitmaps)
    torch.cuda.synchronize()
    launches = crossbar_reduce_cuda.launches
    want = reduce_dense_oracle(table, queries)
    err = float((out - want).abs().max().item())
    if launches <= 0 or err > TOL["float32"] or out.shape != want.shape:
        raise AssertionError(f"flat op: launches {launches}, max_abs_err {err}")
    log(f"flat: ops.crossbar_reduce {tuple(out.shape)} vs reduce_dense_oracle "
        f"max_abs_err {err}, launches {launches}")
    row = parity(torch, timer, "flat-op/q1", image, cq.tile_ids, cq.bitmaps)
    return {"launches": launches, "row": row, "oracle_err": err}


def kernel_entry(name, replaces, launches, row) -> dict:
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/crossbar_reduce.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        # no single PyTorch call computes this masked tile reduction
        "library_ms": None,
    }


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    sys.path.insert(0, str(SRC))
    import numpy as np

    t_start = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")

    from repro_torch.kernels import _build

    path, build_s, build_log = _build.build("crossbar")
    _build.load_crossbar()
    log(f"build: {path.relative_to(ROOT)} in {build_s:.2f} s")
    log("\n".join(l for l in build_log.splitlines() if "registers" in l or "spill" in l))

    timer = Timer(torch)
    phase_parity(torch, timer)
    serving, serving_row, server, tables, streams = phase_serving(torch, np, timer)
    flat = phase_flat(torch, timer, server, tables, streams)

    kernels = [
        kernel_entry("crossbar_reduce_blocked",
                     "src/repro/kernels/crossbar_reduce.py:103",
                     serving["kernel_launches"], serving_row),
        kernel_entry("crossbar_reduce_flat",
                     "src/repro/kernels/crossbar_reduce.py:54",
                     flat["launches"], flat["row"]),
    ]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
