"""Quickstart: the ReCross pipeline end to end (PyTorch port).

The counterpart of ``examples/quickstart.py``:

1. Synthesize an Amazon-Review-like lookup trace (power-law + clusters):
   4,096 rows of width 128, a 512-query history and 256 online queries.
2. Offline phase: co-occurrence graph → Algorithm-1 grouping → Eq.-1
   log-scaled replication → crossbar layout.
3. Online phase: reduce 32 queries through ``ops.crossbar_reduce`` (the
   flat crossbar kernel on a card) and hold them against the dense
   oracle at the reference's ``atol=1e-3``.
4. The READ/MAC mix of the dynamic switch, then the simulated ReRAM cost
   of ReCross against the naive, nMARS and CPU baselines.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

The device defaults to ``cuda``.  On a card the reduction launches the
hand-written kernel or raises ``KernelError``; there is no fallback to the
CPU, which runs the kernel's plain version only when asked for with
``--device cpu``.  :func:`main` returns the numbers it prints.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import numpy as np
import torch

from repro_torch.core import (
    baselines,
    build_cooccurrence,
    compile_queries,
    mode_statistics,
    reduce_dense_oracle,
    simulate_cpu_baseline,
)
from repro_torch.core.mapping import query_tile_bitmaps
from repro_torch.data import zipf_queries
from repro_torch.kernels import ops

NUM_ROWS, DIM, GROUP = 4096, 128, 64
#: queries reduced through the kernel and the dense oracle
KERNEL_QUERIES = 32
#: examples/quickstart.py's tolerance
ATOL = 1e-3


def main(device="cuda") -> Dict[str, object]:
    """Runs the quickstart on ``device`` and prints what it finds.

    Returns:
      The offline numbers (``edges``, ``groups``, ``tiles``), the
      kernel's ``out`` tensor and its ``max_abs_err`` against the dense
      oracle, the dynamic switch's ``read_fraction``, and the simulated
      speedups and energy ratios against the baselines.

    Raises:
      AssertionError: the kernel's output differs from the oracle by
        more than ``ATOL``.
    """
    # 1. workload
    history = zipf_queries(NUM_ROWS, 512, mean_bag=20.0, seed=0)
    online = zipf_queries(NUM_ROWS, 256, mean_bag=20.0, seed=1)

    # 2. offline phase
    graph = build_cooccurrence(history, NUM_ROWS)
    layout, recross = baselines.recross_pipeline(
        graph, online, group_size=GROUP, dim=DIM, batch_size=256
    )
    print(f"offline: {graph.edge_count()} co-occurrence edges -> "
          f"{layout.num_groups} groups, {layout.num_tiles} tiles "
          f"(replication ratio {layout.num_tiles / layout.num_groups:.2f})")

    # 3. online phase: the kernel against the dense oracle
    table = np.random.default_rng(0).normal(size=(NUM_ROWS, DIM)).astype(np.float32)
    image = torch.from_numpy(
        layout.build_image(table).reshape(layout.num_tiles, layout.tile_rows, DIM)
    ).to(device)
    cq = compile_queries(layout, online[:KERNEL_QUERIES], device=device)
    out = ops.crossbar_reduce(image, cq.tile_ids, cq.bitmaps)
    oracle = reduce_dense_oracle(torch.from_numpy(table).to(device), online[:KERNEL_QUERIES])
    err = float((out - oracle).abs().max())
    if not err <= ATOL:
        raise AssertionError(f"kernel != oracle: max_abs_err {err}")
    print(f"online: crossbar_reduce on {out.device} matches the dense oracle "
          f"(max_abs_err {err:.3g})")

    _, counts = query_tile_bitmaps(layout, online[:256])
    stats = mode_statistics(counts)
    print(f"dynamic switch: {stats['read_fraction'] * 100:.1f}% of activations "
          f"take the READ path (single embedding)")

    # 4. cost simulation
    _, naive = baselines.naive_pipeline(NUM_ROWS, online)
    _, nmars = baselines.nmars_pipeline(NUM_ROWS, online)
    cpu = simulate_cpu_baseline(online)
    res = {
        "device": str(out.device),
        "edges": graph.edge_count(),
        "groups": layout.num_groups,
        "tiles": layout.num_tiles,
        "max_abs_err": err,
        "read_fraction": stats["read_fraction"],
        "speedup_vs_naive": recross.speedup_over(naive),
        "speedup_vs_nmars": recross.speedup_over(nmars),
        "energy_vs_naive": recross.energy_efficiency_over(naive),
        "energy_vs_cpu": cpu.energy_pj / recross.energy_pj,
    }
    print(f"simulated speedup   : {res['speedup_vs_naive']:.2f}x vs naive, "
          f"{res['speedup_vs_nmars']:.2f}x vs nMARS")
    print(f"simulated energy eff: {res['energy_vs_naive']:.2f}x vs naive, "
          f"{res['energy_vs_cpu']:.0f}x vs CPU")
    res["out"] = out
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the kernel) or cpu (its plain version)")
    result = main(ap.parse_args().device)
    result.pop("out")
    print(json.dumps(result))
