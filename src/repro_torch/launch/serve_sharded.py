"""Sharded multi-table serving launcher (PyTorch port).

Stands up a :class:`~repro_torch.serve.sharded.ShardedEmbeddingServer`
over synthetic tables with one process per shard (a
:class:`~repro_torch.dist.mesh.ShardMesh`: rank 0 runs the server, the
other ranks :func:`~repro_torch.serve.sharded.serve_worker`), or on one
device with ``--emulate`` (the shards emulated in the shard loop), drives
a stream of per-table Zipf queries through
``submit``/``flush`` (or, with ``--producers N``, from N producer threads
and one final ``drain``) and prints the report as JSON.  With
``--drift`` every row id of the stream's tail is remapped through a fixed
permutation (a hot-set rotation the offline plan never saw) and the
server replans online (``replan=``).  With ``--capacity-frac`` (or
``--capacity-tiles``) the device holds only that share of the image as a
hot tier; cold queries take the host gather+sum and drift pages groups
in and out (``tiers=``).  ``--inject`` replays a seeded fault schedule
(``faults=``, the reference's plan for the same seed) against the
self-healing policy.

Usage::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve_sharded --shards 4
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --shards 4 --backend gloo
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --emulate
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --emulate --device cpu \\
        --rows 512 --history 256 --requests 128 --batch-size 32
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --shards 4 \\
        --flush-policy owner-set --owner-set-max 2 --threaded --producers 2 --skew 3
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --device cpu \
        --shards 2 --tables 2 --rows 512 --history 512 --requests 384 \
        --batch-size 32 --drift --replan-min-queries 32 --replan-half-life 2
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --device cpu \
        --flush-policy deadline --capacity-frac 0.25 --drift
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --device cpu \
        --flush-policy per-shard --threaded \
        --inject compile:2,device:1,poison:1,hang:1 --inject-seed 0 --watchdog 2.0

Without ``--emulate`` the ranks come from ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``), or the launcher, as rank 0, spawns
``--shards - 1`` worker processes itself, joined by a ``file://`` store in
a temporary directory.  ``--backend`` picks the data plane's collectives
(NCCL by default on the card, gloo on the CPU; NCCL puts at most one rank
on a card, so several ranks on one card need ``--backend gloo``).  Rank 0
prints the report; a worker exits 0 once the server's ``STOP`` reached
it, and the launcher exits non-zero if a worker failed.

The device defaults to ``cuda``; there is no fallback to the CPU, which
runs the kernels' plain versions only when asked for with ``--device cpu``.
On the card an injected hang past ``--watchdog`` raises ``FlushTimeout``
(its batch requeued); only ``--device cpu`` degrades it to the host.
The run fails (non-zero exit) if a producer thread raised or the server
quarantined a query that the fault plan did not poison.  The module is
import-safe: arguments are parsed only under ``__main__``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import tempfile
import threading
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for the shard images and kernels")
    ap.add_argument("--shards", type=int, default=1,
                    help="shards to plan for: one process each, or emulated "
                         "on one device with --emulate")
    ap.add_argument("--emulate", action="store_true",
                    help="single-device shard loop instead of one process per shard")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                    help="the combine's collectives across the shard processes "
                         "(default: nccl on cuda, gloo on cpu)")
    ap.add_argument("--combine", choices=["psum_scatter", "psum"],
                    default="psum_scatter",
                    help="cross-shard combine: reduce-scatter over the embedding "
                         "dim + all-gather, or all-reduce")
    ap.add_argument("--tables", type=int, default=2)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--history", type=int, default=2048)
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--q-block", type=int, default=8)
    ap.add_argument("--group-size", type=int, default=64)
    ap.add_argument("--mean-bag", type=float, default=12.0)
    ap.add_argument("--combine-chunks", type=int, default=2)
    ap.add_argument("--flush-policy",
                    choices=["global", "per-shard", "deadline", "owner-set"],
                    default="global",
                    help="global: synchronous fused flushes; per-shard/deadline: "
                         "shards flush independently as their block unions fill, "
                         "host compile pipelined against device execution; "
                         "owner-set: multi-owner queries key their home by the "
                         "frozen owner set and flush over exactly those shards "
                         "(DESIGN.md §7)")
    ap.add_argument("--owner-set-max", type=int, default=None,
                    help="owner-set policy: sets larger than this pool up "
                         "instead of getting their own home (None: every set)")
    ap.add_argument("--producers", type=int, default=1,
                    help="concurrent producer threads (DESIGN.md §10): the "
                         "stream splits round-robin, each thread submits under "
                         "its own label and one final drain merges the streams "
                         "in (local_seq, producer_id) order; > 1 requires an "
                         "async --flush-policy")
    ap.add_argument("--threaded", action="store_true",
                    help="run the async engine on a driver thread: submit() "
                         "only validates and enqueues (DESIGN.md §7.2)")
    ap.add_argument("--union-budget", type=int, default=None,
                    help="per-home block-union fill that triggers a flush")
    ap.add_argument("--flush-deadline", type=int, default=None,
                    help="max submissions a pending query waits before a "
                         "forced flush (deadline/owner-set default 4x batch-size)")
    ap.add_argument("--max-in-flight", type=int, default=2,
                    help="bound on dispatched-but-unretired async flushes")
    ap.add_argument("--skew", type=float, default=1.0,
                    help="per-table arrival skew: table i receives weight "
                         "skew^-i of the stream (1.0 = uniform)")
    ap.add_argument("--watchdog", type=float, default=None,
                    help="per-flush watchdog deadline in seconds: a flush not "
                         "ready by then raises on the card (its batch is "
                         "requeued); with --device cpu the host gather+sum "
                         "serves it")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="in-place re-dispatch attempts per failed flush "
                         "before bisection/quarantine")
    ap.add_argument("--drift", action="store_true",
                    help="drifting-workload replay: rotate the hot set "
                         "mid-stream and replan online")
    ap.add_argument("--drift-at", type=float, default=0.5,
                    help="fraction of the stream after which rows remap")
    ap.add_argument("--drift-seed", type=int, default=7)
    ap.add_argument("--replan-threshold", type=float, default=0.2)
    ap.add_argument("--replan-half-life", type=float, default=4.0)
    ap.add_argument("--replan-min-queries", type=int, default=64)
    ap.add_argument("--slack-tiles", type=int, default=8,
                    help="per-shard zero-tile image headroom for promotions")
    ap.add_argument("--capacity-frac", type=float, default=None,
                    help="tiered storage (DESIGN.md §9): cap the per-shard "
                         "hot-tier image at this fraction of what an uncapped "
                         "plan needs; cold queries take the host gather+sum "
                         "and drift pages groups in and out at barriers")
    ap.add_argument("--capacity-tiles", type=int, default=None,
                    help="absolute per-shard hot-tier budget in tiles "
                         "(instead of --capacity-frac)")
    ap.add_argument("--tier-hysteresis", type=float, default=1.5,
                    help="load ratio a cold group must beat over its eviction "
                         "victim to page in (>= 1)")
    ap.add_argument("--host-batch", type=int, default=None,
                    help="cold queries buffered before a host flush "
                         "(default: --batch-size)")
    ap.add_argument("--host-deadline", type=int, default=None,
                    help="max submissions a queued cold query waits before a "
                         "forced host flush (default: 4x host batch)")
    ap.add_argument("--inject", default=None, metavar="KIND:N[,KIND:N...]",
                    help="chaos replay (DESIGN.md §8): a seeded fault schedule, "
                         "e.g. 'compile:2,device:1,poison:2,hang:1'.  Kinds: "
                         "compile (transient host-compile failure), device "
                         "(fault at dispatch), device-late (fault at retire), "
                         "hang (the flush never reports ready; pair with "
                         "--watchdog), poison (a (table, seq) query that fails "
                         "every batch holding it until bisection quarantines "
                         "it), patch (the staged plan patch fails to apply)")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="fault-plan draw and retry-jitter seed")
    ap.add_argument("--inject-hang-s", type=float, default=None,
                    help="simulated duration of injected hangs (default: "
                         "forever, the watchdog's job)")
    return ap.parse_args(argv)


def build_fault_plan(args, table_names, requests):
    """``--inject 'compile:2,poison:1'`` → the seeded FaultPlan the
    reference's launcher draws for the same arguments (None without
    ``--inject``)."""
    if not args.inject:
        return None
    from repro_torch.serve.faults import FaultPlan

    counts = {}
    for part in args.inject.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, n = part.partition(":")
        counts[kind.strip()] = int(n) if n else 1
    per_table = max(1, requests // max(1, len(table_names)))
    producers = (
        tuple(f"p{i}" for i in range(args.producers))
        if args.producers > 1 else ()
    )
    return FaultPlan.random(
        args.inject_seed, counts,
        horizon=max(4, requests // max(1, args.batch_size)),
        tables=tuple(table_names),
        max_seq=max(1, per_table // max(1, args.producers)),
        hang_s=args.inject_hang_s,
        producers=producers,
    )


def main(args, mesh=None) -> dict:
    """Serves the stream with rank 0's server on ``mesh`` (``None``: the
    emulated server) and returns its report."""
    import numpy as np

    from repro_torch.convert import tables_from_numpy
    from repro_torch.data import zipf_queries
    from repro_torch.serve import (
        ReplanConfig,
        RetryPolicy,
        ShardedEmbeddingServer,
        TierConfig,
    )

    rng = np.random.default_rng(0)
    tables = tables_from_numpy({
        f"t{i}": rng.normal(size=(args.rows, args.dim)).astype(np.float32)
        for i in range(args.tables)
    }, args.device)
    histories = {
        name: zipf_queries(args.rows, args.history, args.mean_bag, seed=i)
        for i, name in enumerate(tables)
    }
    server = ShardedEmbeddingServer(
        tables, histories,
        num_shards=args.shards, mesh=mesh, q_block=args.q_block,
        group_size=args.group_size, batch_size=args.batch_size,
        combine=args.combine, combine_chunks=args.combine_chunks, device=args.device,
        flush_policy=args.flush_policy,
        union_budget=args.union_budget,
        flush_deadline=args.flush_deadline,
        owner_set_max=args.owner_set_max,
        max_in_flight=args.max_in_flight,
        threaded=args.threaded,
        retry=RetryPolicy(max_retries=args.max_retries, watchdog_s=args.watchdog,
                          seed=args.inject_seed),
        replan=ReplanConfig(
            threshold=args.replan_threshold,
            half_life=args.replan_half_life,
            min_queries=args.replan_min_queries,
            slack_tiles=args.slack_tiles,
        ) if args.drift else None,
        tiers=TierConfig(
            capacity_tiles=args.capacity_tiles,
            capacity_frac=args.capacity_frac,
            hysteresis=args.tier_hysteresis,
            host_batch=args.host_batch,
            host_deadline=args.host_deadline,
        ) if args.capacity_frac is not None or args.capacity_tiles is not None
        else None,
        faults=build_fault_plan(args, list(tables), args.requests),
    )
    stream = zipf_queries(args.rows, args.requests, args.mean_bag, seed=1234)
    if args.drift:
        # hot-set rotation: the stream's tail remaps every row id through
        # a fixed permutation, which the replanner must chase online
        cut = int(len(stream) * args.drift_at)
        perm = np.random.default_rng(args.drift_seed).permutation(args.rows)
        stream = stream[:cut] + [
            perm[np.asarray(q, dtype=np.int64)].tolist() for q in stream[cut:]
        ]
    names = list(tables)
    # per-table arrival replay: round robin at skew 1, weighted choice
    # otherwise (table i's arrival rate ∝ skew^-i)
    if args.skew != 1.0:
        w = np.power(float(args.skew), -np.arange(len(names)))
        pick = np.random.default_rng(5).choice(len(names), size=len(stream), p=w / w.sum())
    else:
        pick = np.arange(len(stream)) % len(names)
    flushed = 0
    if args.producers > 1:
        if args.flush_policy == "global":
            raise SystemExit("--producers > 1 requires an async --flush-policy")
        labels = [f"p{i}" for i in range(args.producers)]
        slices = {
            lab: [(names[int(pick[i])], stream[i])
                  for i in range(len(stream)) if i % args.producers == p]
            for p, lab in enumerate(labels)
        }
        # registration order pins producer ids (the merge tiebreak)
        for lab in labels:
            server.register_producer(lab)

        errors = []

        def run(lab):
            try:
                for name, q in slices[lab]:
                    server.submit(name, q, producer=lab)
            except Exception as e:  # re-raised on the main thread below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(lab,), name=lab) for lab in labels]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            server.close()
            raise errors[0]
        if server.drain():
            flushed += 1
        wall = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        for i, q in enumerate(stream):
            if server.submit(names[int(pick[i])], q):
                flushed += 1
        if server.flush():
            flushed += 1
        wall = time.perf_counter() - t0
    server.close()
    report = server.report()
    report["flushes"] = flushed
    report["replay_wall_s"] = wall
    report["producers"] = args.producers
    return report


def _share_host(args) -> None:
    """On the CPU the shard processes share the host's cores: each rank
    takes an equal share of intra-op threads, or the plain kernels and
    gloo's reductions of the ranks starve each other."""
    if args.device == "cpu":
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, args.shards)))


def _worker(rank, args, init_method) -> None:
    """A spawned shard process: joins the world and serves until STOP."""
    from repro_torch.dist.mesh import init_shard_mesh
    from repro_torch.serve.sharded import serve_worker

    _share_host(args)
    mesh = init_shard_mesh(args.shards, rank=rank, world_size=args.shards,
                           device=args.device, backend=args.backend,
                           init_method=init_method)
    try:
        serve_worker(mesh)
    finally:
        mesh.close()


def run(args) -> dict | None:
    """Runs the launcher: emulated, as one ``torchrun`` rank, or as rank
    0 of a world it spawns.  Returns rank 0's report (``None`` on the
    other ranks)."""
    if args.emulate:
        return main(args)
    from repro_torch.dist.mesh import init_shard_mesh
    from repro_torch.serve.sharded import serve_worker

    _share_host(args)
    if "RANK" in os.environ:
        mesh = init_shard_mesh(args.shards, device=args.device, backend=args.backend)
        try:
            if mesh.rank == 0:
                return main(args, mesh)
            serve_worker(mesh)
            return None
        finally:
            mesh.close()
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        ctx = mp.get_context("spawn")
        workers = [ctx.Process(target=_worker, args=(r, args, init), daemon=True)
                   for r in range(1, args.shards)]
        for w in workers:
            w.start()
        try:
            mesh = init_shard_mesh(args.shards, rank=0, world_size=args.shards,
                                   device=args.device, backend=args.backend,
                                   init_method=init)
            try:
                report = main(args, mesh)
            finally:
                mesh.close()
            for w in workers:
                w.join(timeout=60)
        finally:
            for w in workers:
                if w.is_alive():
                    w.kill()
                    w.join()
    failed = [r for r, w in enumerate(workers, 1) if w.exitcode != 0]
    if failed:
        raise SystemExit(f"shard worker(s) {failed} failed")
    return report


if __name__ == "__main__":
    report = run(parse_args())
    if report is None:  # a torchrun worker rank: rank 0 reports
        raise SystemExit(0)
    print(json.dumps(report, indent=1, default=str))
    poisoned = report.get("faults", {}).get("plan", {}).get("poisoned", [])
    unplanned = [q for q in report["serve"]["faults"]["quarantined"]
                 if q[:2] not in poisoned]
    if unplanned:
        raise SystemExit(f"{len(unplanned)} queries quarantined without a "
                         f"planned poison: {unplanned}")
