"""The control of the check: a cell served in a lower precision.

The configurations state float32 tables.  The program has a bfloat16 path
of its own (a server over bfloat16 tables keeps a bfloat16 image and
bitmaps, and the kernel returns bfloat16 rows), so the control is the
program with that path on: the same tables rounded to bfloat16, the same
requests, the same window, held against the same float32 reference and
limits.  The check is sound only if the control comes out not correct.

Run on the card, one process for several seeds (each builds its server)::

    python3 recbench/control.py --workload <cell> --seeds 1,2,3 --seconds 10

One JSON line a seed: its readings beside the limits, and ``correct``.
The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    from recbench import run

    run.prepare_process()

    import torch

    from recbench import harness

    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 1
    cell = harness.resolve(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        line, _ = run.execute(ROOT, cell, seed, args.seconds, False, "cuda",
                              time.perf_counter(), dtype=torch.bfloat16)
        print(json.dumps({"workload": cell.name, "dtype": "bfloat16", "seed": seed,
                          "correct": line["correct"], "attempted": line["attempted"],
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
