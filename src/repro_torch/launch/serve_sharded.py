"""Sharded multi-table serving launcher (PyTorch port, global flushes).

Stands up a :class:`~repro_torch.serve.sharded.ShardedEmbeddingServer`
over synthetic tables on one device (``--shards`` are emulated in the
shard loop), drives a stream of per-table Zipf queries through
``submit``/``flush`` and prints the report as JSON.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve_sharded
    PYTHONPATH=src python -m repro_torch.launch.serve_sharded --device cpu \\
        --rows 512 --history 256 --requests 128 --batch-size 32

The device defaults to ``cuda``; there is no fallback to the CPU, which
runs the kernels' plain versions only when asked for with ``--device cpu``.
The module is import-safe: arguments are parsed only under ``__main__``.
"""

from __future__ import annotations

import argparse
import json
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device for the shard images and kernels")
    ap.add_argument("--shards", type=int, default=1,
                    help="shards to plan for, emulated on the one device")
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
    return ap.parse_args(argv)


def main(args) -> dict:
    import numpy as np

    from repro_torch.convert import tables_from_numpy
    from repro_torch.data import zipf_queries
    from repro_torch.serve import ShardedEmbeddingServer

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
        num_shards=args.shards, q_block=args.q_block,
        group_size=args.group_size, batch_size=args.batch_size,
        combine_chunks=args.combine_chunks, device=args.device,
    )
    stream = zipf_queries(args.rows, args.requests, args.mean_bag, seed=1234)
    names = list(tables)
    flushed = 0
    t0 = time.perf_counter()
    for i, q in enumerate(stream):
        if server.submit(names[i % len(names)], q):
            flushed += 1
    if server.flush():
        flushed += 1
    wall = time.perf_counter() - t0
    server.close()
    report = server.report()
    report["flushes"] = flushed
    report["replay_wall_s"] = wall
    return report


if __name__ == "__main__":
    print(json.dumps(main(parse_args()), indent=1, default=str))
