"""Worlds of gloo ranks on the CPU for ``tests/test_torch_mesh.py``.

A world is ``size`` processes started with the ``spawn`` method, joined
by a ``file://`` store, each running the same list of cases in order
(the mesh path is SPMD: every rank must issue the same collectives).
Each case is a function of this module taking ``(mesh, **kwargs)``;
rank 0's return values come back to the caller.  Once a case raises on
any rank the world is out of step, so every rank stops there and the
remaining cases report as not run.  This module imports no ``jax``, so a
rank imports only the port.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import threading
import time
import traceback

import numpy as np

NOT_RUN = "not run: an earlier case of this world failed"


# ------------------------------------------------------------- inputs --


def int_table(rows, dim, seed):
    """Integer-valued f32 table: partial sums are exact in float32."""
    return np.random.default_rng(seed).integers(-8, 9, size=(rows, dim)).astype(np.float32)


def kernel_inputs(num_shards, parts, *, dim=128, seed=0, rows=192, batch=24,
                  table="int"):
    """One table, its history and a batch whose every row lies in a
    group held by a shard of ``parts`` (or by every shard), so a flush of
    those participants covers it: the reference's
    ``tests/test_sharded_serving.py`` setup, filtered for subsets."""
    from repro_torch.data import zipf_queries

    hist = zipf_queries(rows, 48, 6.0, seed=seed)
    if table == "int":
        tab = int_table(rows, dim, seed)
    else:
        tab = np.random.default_rng(seed).standard_normal((rows, dim)).astype(np.float32)
    plan, layout = _plan(tab, hist, num_shards)
    ok = np.isin(plan.shard_of_group[layout.group_of], list(parts) + [-1])
    queries = []
    for q in zipf_queries(rows, 8 * batch, 6.0, seed=seed + 1):
        keep = [int(r) for r in q if ok[r]]
        if keep:
            queries.append(keep)
        if len(queries) == batch:
            break
    return tab, hist, queries


def _plan(table, hist, num_shards, group_size=16, eq1_batch=64):
    from repro_torch.core import (
        build_cooccurrence, build_layout, correlation_aware_grouping, plan_replication,
    )
    from repro_torch.dist import plan_shards

    g = build_cooccurrence(hist, table.shape[0])
    grouping = correlation_aware_grouping(g, group_size)
    rep = plan_replication(grouping, g.freq, eq1_batch)
    layout = build_layout(grouping, rep, table.shape[1])
    plan = plan_shards([layout], [rep], num_shards,
                       group_freqs=[grouping.group_freq(g.freq)])
    return plan, layout


def port_stack(table, hist, queries, num_shards, parts, *, q_block=4, dtype="float32"):
    """The port's shard image stack and the participants' stacked
    schedule of ``queries``."""
    import torch

    from repro_torch.core import compile_queries, shard_block_queries
    from repro_torch.dist import build_fused_image

    dt = getattr(torch, dtype)
    plan, layout = _plan(table, hist, num_shards)
    fused = build_fused_image([layout], [table])
    images = torch.from_numpy(plan.build_shard_images(fused)).to(dt)
    cq = compile_queries(layout, queries, replica_block=q_block, dtype=dt, device="cpu")
    sbq = shard_block_queries(cq, plan, q_block, participants=parts, device="cpu")
    return images, sbq


# -------------------------------------------------------------- cases --


def case_reduce(mesh, *, parts, combine, chunks, dim=128, seed=0, table="int",
                dtype="float32"):
    """SPMD crossbar_reduce_sharded over the mesh: each rank takes its
    own shard and schedule (all -1 outside ``parts``); rank 0 returns
    the result as float32 numpy, with the combine route."""
    import torch

    from repro_torch.kernels.sharded import combine_route, crossbar_reduce_sharded

    S = mesh.size
    tab, hist, queries = kernel_inputs(S, parts, dim=dim, seed=seed, table=table)
    images, sbq = port_stack(tab, hist, queries, S, parts, dtype=dtype)
    me = mesh.rank
    if me in parts:
        p = list(parts).index(me)
        ids, bms = sbq.tile_ids[p:p + 1], sbq.bitmaps[p:p + 1]
    else:
        ids = torch.full_like(sbq.tile_ids[:1], -1)
        bms = torch.zeros_like(sbq.bitmaps[:1])
    out = crossbar_reduce_sharded(
        images[me:me + 1], ids, bms, mesh=mesh, combine=combine,
        combine_chunks=chunks, shard_ids=parts,
    )
    if me != 0:
        return None
    return {"out": out.float().numpy()[: sbq.batch],
            "route": combine_route(S, parts, dim, combine),
            "subgroups": mesh.cache_stats()}


def synthetic_patches(num_shards, capacity):
    """A grow with writes to every shard, then a shrink with one
    relocation: the depth changes on every rank."""
    from repro_torch.dist import PlanPatch

    def patch(cap, dma=(), moved=()):
        return PlanPatch(promoted=[], demoted=[], dma=list(dma), freed=[],
                         new_capacity=cap, drifted_load=np.zeros(1), moved=list(moved))

    grow = [(s, capacity + s % 3, s) for s in range(num_shards)]
    return [patch(capacity + 3, grow),
            patch(capacity + 1, moved=[(num_shards - 1, 0, capacity + 2, capacity)])]


def case_patch(mesh, *, seed=0, eq1_batch=32):
    """The reference's patched-plan mesh test (``tests/test_replan.py``):
    a plan patch for reversed loads applied by the SPMD
    ``patch_shard_images``, the batch reduced over the patched plan, then
    a synthetic grow and shrink; rank 0 gathers every rank's shard."""
    import torch

    from repro_torch.core import compile_queries, shard_block_queries
    from repro_torch.dist import apply_plan_patch, build_fused_image, compute_plan_patch
    from repro_torch.kernels.sharded import crossbar_reduce_sharded, patch_shard_images

    S, me = mesh.size, mesh.rank
    tab, hist, queries = kernel_inputs(S, list(range(S)), seed=seed)
    plan, layout = _plan(tab, hist, S)
    fused = build_fused_image([layout], [tab])
    own = torch.from_numpy(plan.build_shard_images(fused)[me:me + 1].copy())
    patch = compute_plan_patch(plan, plan.group_load[::-1].copy(), eq1_batch=eq1_batch)
    src = (patch, fused) if me == 0 else (None, None)
    own = patch_shard_images(own, *src, mesh=mesh)
    cq = compile_queries(layout, queries, replica_block=4, device="cpu")
    sbq = shard_block_queries(cq, apply_plan_patch(plan, patch), 4)
    out = crossbar_reduce_sharded(own, sbq.tile_ids[me:me + 1], sbq.bitmaps[me:me + 1],
                                  mesh=mesh, combine_chunks=2)
    for extra in synthetic_patches(S, own.shape[1]):
        own = patch_shard_images(own, *((extra, fused) if me == 0 else (None, None)),
                                 mesh=mesh)
    if me != 0:
        mesh.send(own, 0)
        return None
    shards = [own] + [mesh.recv(tuple(own.shape), own.dtype, src=r) for r in range(1, S)]
    return {"images": torch.cat(shards).numpy(), "out": out.numpy()[: sbq.batch],
            "writes": len(patch.dma) + len(patch.moved)}


def server_stream(rows, n, seed, *, tables=("a",)):
    from repro_torch.data import zipf_queries

    return {t: zipf_queries(rows, n, 5.0, seed=seed + i) for i, t in enumerate(tables)}


def server_setup(num_shards, *, rows=96, dim=128, seed=3, tables=("a",)):
    """The reference's ``tests/test_scheduler.py`` mesh setup: integer-valued
    tables and Zipf histories."""
    from repro_torch.data import zipf_queries

    tabs = {t: int_table(rows, dim, seed + i) for i, t in enumerate(tables)}
    hists = {t: zipf_queries(rows, 32, 5.0, seed=1 + i) for i, t in enumerate(tables)}
    return tabs, hists


def _server_kwargs(kw):
    from repro_torch.serve import ReplanConfig, TierConfig

    kw = dict(kw)
    if "replan" in kw:
        kw["replan"] = ReplanConfig(**kw["replan"])
    if "tiers" in kw:
        kw["tiers"] = TierConfig(**kw["tiers"])
    return kw


def rows_np(o):
    """A served row block as float32 NumPy (torch or JAX)."""
    import torch

    if isinstance(o, torch.Tensor):
        return o.float().numpy()
    return np.asarray(o, np.float32)


def drive(server, stream, producers=0):
    """Submits ``stream`` (``[(table, query), ...]``) and drains: from
    ``producers`` threads taking the positions round robin, or inline
    with ``flush()``.  Returns ``{table: float32 rows}`` in the drain's
    order."""
    outs = {}
    if producers:
        labels = [f"p{i}" for i in range(producers)]
        for lab in labels:
            server.register_producer(lab)
        errors = []

        def run(p):
            try:
                for name, q in stream[p::producers]:
                    server.submit(name, q, producer=labels[p])
            except Exception as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(p,)) for p in range(producers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        if errors:
            raise errors[0]
        for n, o in server.drain().items():
            outs.setdefault(n, []).append(rows_np(o))
    else:
        for name, q in stream:
            for n, o in server.submit(name, q).items():
                outs.setdefault(n, []).append(rows_np(o))
        for n, o in server.flush().items():
            outs.setdefault(n, []).append(rows_np(o))
    return {n: np.concatenate(v) for n, v in outs.items()}


def case_server(mesh, *, setup, stream, producers=0, **kw):
    """A mesh server on rank 0 over ``setup`` (``server_setup`` kwargs)
    serving ``stream``; every other rank runs serve_worker.  Rank 0
    returns the rows, the stats summary and the report."""
    from repro_torch.convert import tables_from_numpy
    from repro_torch.serve import ShardedEmbeddingServer
    from repro_torch.serve.sharded import serve_worker

    if mesh.rank != 0:
        return serve_worker(mesh)
    tabs, hists = server_setup(mesh.size, **setup)
    server = ShardedEmbeddingServer(
        tables_from_numpy(tabs, "cpu"), hists, num_shards=mesh.size, mesh=mesh,
        device="cpu", **_server_kwargs(kw),
    )
    try:
        rows = drive(server, stream, producers)
    finally:
        server.close()
    return {"rows": rows, "summary": server.stats.summary(), "report": server.report(),
            "image_shape": tuple(server.shard_images.shape)}


def case_worker_failure(mesh, *, setup, stream, **kw):
    """Rank 1's kernel raises inside its flush; rank 0 returns what its
    server raised and how long that took."""
    from repro_torch.convert import tables_from_numpy
    from repro_torch.serve import ShardedEmbeddingServer
    from repro_torch.serve.sharded import serve_worker

    if mesh.rank != 0:
        import repro_torch.kernels.sharded as ks

        def broken(*a, **k):
            raise RuntimeError("injected worker fault")

        ks.crossbar_reduce_cuda = broken
        return serve_worker(mesh)
    tabs, hists = server_setup(mesh.size, **setup)
    server = ShardedEmbeddingServer(
        tables_from_numpy(tabs, "cpu"), hists, num_shards=mesh.size, mesh=mesh,
        device="cpu", **_server_kwargs(kw),
    )
    t0 = time.perf_counter()
    try:
        drive(server, stream)
    except Exception as e:
        err = (type(e).__name__, str(e))
    else:
        err = None
    return {"error": err, "seconds": time.perf_counter() - t0,
            "mode": server.report()["mesh"]}


CASES = {"reduce": case_reduce, "patch": case_patch, "server": case_server,
         "worker_failure": case_worker_failure}


# -------------------------------------------------------------- world --


def _rank_main(rank, size, init_method, cases, results, timeout_s):
    import torch

    from repro_torch.dist.mesh import init_shard_mesh

    # the ranks share the host's cores: one intra-op thread each, or the
    # plain kernels and gloo's reductions starve each other
    torch.set_num_threads(1)
    mesh = init_shard_mesh(rank=rank, world_size=size, device="cpu",
                           init_method=init_method, timeout_s=timeout_s)
    run_cases(mesh, cases, CASES, results, rank)
    mesh.close()


def run_cases(target, cases, table, results, rank) -> None:
    """Runs ``cases`` in order with ``table[kind](target, **kwargs)``;
    after a case raises, the rest report as not run.  Rank 0 puts
    ``{name: (status, value)}`` on ``results``."""
    out, failed = {}, False
    for name, kind, kwargs in cases:
        if failed:
            out[name] = ("error", NOT_RUN)
            continue
        try:
            out[name] = ("ok", table[kind](target, **kwargs))
        except Exception:  # reported to the test, which fails on it
            out[name] = ("error", traceback.format_exc())
            failed = True
    if rank == 0:
        results.put(out)


def run_world(size, cases, tmpdir, *, timeout_s=30.0, wait_s=120.0, rank_main=None):
    """Runs ``cases`` (``[(name, kind, kwargs), ...]``) on a world of
    ``size`` gloo ranks; returns rank 0's ``{name: (status, value)}``.
    ``rank_main`` (a module-level function taking ``(rank, size,
    init_method, cases, results, timeout_s)``) starts each rank; by
    default a shard mesh running this module's cases.  Every process is
    ended before this returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    os.makedirs(str(tmpdir), exist_ok=True)
    init = f"file://{os.path.join(str(tmpdir), 'store')}"
    procs = [ctx.Process(target=rank_main or _rank_main,
                         args=(r, size, init, cases, results, timeout_s),
                         daemon=True) for r in range(size)]
    for p in procs:
        p.start()
    out = None
    deadline = time.monotonic() + wait_s
    try:
        while out is None and time.monotonic() < deadline:
            try:
                out = results.get(timeout=0.2)
            except queue.Empty:
                if procs[0].exitcode is not None:  # rank 0 ended with no result
                    break
        if out is None:
            out = {name: ("error", "the world returned no result")
                   for name, _, _ in cases}
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return out
