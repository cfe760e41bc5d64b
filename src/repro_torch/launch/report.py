"""Renders the dry run's roofline and dry-run tables from the per-cell
JSON records produced by :mod:`repro_torch.launch.dryrun`.

The port of ``repro.launch.report``, line for line; it reads the port's
cell files.  ``python -m repro_torch.launch.report [--dir build/dryrun]
[--section roofline|dryrun|pick]`` prints markdown (or, for ``pick``, the
hill-climb cells as JSON).
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(results_dir: str, *, include_variants: bool = False) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(results_dir, "*.json"))):
        with open(path) as f:
            c = json.load(f)
        # variant cells carry a 4th "__"-separated component
        if not include_variants and c.get("cell", "").count("__") > 2:
            continue
        cells.append(c)
    return cells


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.0f}us"


def roofline_table(cells: list[dict], mesh: str = "pod16x16") -> str:
    """§Roofline: single-pod only (per the spec); multi-pod proves sharding."""
    lines = [
        "| arch | shape | compute | memory | collective | dominant | "
        "roofline frac | 6ND/analytic | mem/dev |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in sorted(cells, key=lambda c: (c["arch"], c["shape"])):
        if c["mesh"] != mesh:
            continue
        r = c["roofline"]
        ratio = r.get("useful_flops_ratio")
        lines.append(
            f"| {c['arch']} | {c['shape']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {r['roofline_fraction']:.3f} "
            f"| {(f'{ratio:.2f}' if ratio else 'n/a')} "
            f"| {c['memory_analysis']['per_device_total_gib']:.1f}GiB |"
        )
    return "\n".join(lines)


def dryrun_table(cells: list[dict]) -> str:
    lines = [
        "| cell | chips | compile | mem/dev | collective GB (corrected) | "
        "breakdown |",
        "|---|---|---|---|---|---|",
    ]
    for c in sorted(cells, key=lambda c: (c["arch"], c["shape"], c["mesh"])):
        r = c["roofline"]
        bd = ", ".join(
            f"{k}:{v / 2**30:.1f}" for k, v in sorted(
                r.get("collective_breakdown", {}).items(), key=lambda kv: -kv[1]
            )[:3]
        )
        lines.append(
            f"| {c['cell']} | {c['chips']} | {c.get('compile_seconds', 0):.0f}s "
            f"| {c['memory_analysis']['per_device_total_gib']:.1f}GiB "
            f"| {r['collective_bytes'] / 2**30:.1f} | {bd} |"
        )
    return "\n".join(lines)


def pick_hillclimb_cells(cells: list[dict]) -> dict:
    """worst roofline fraction / most collective-bound / paper-representative."""
    single = [c for c in cells if c["mesh"] == "pod16x16" and "roofline" in c]
    if not single:
        return {}
    worst = min(single, key=lambda c: c["roofline"]["roofline_fraction"])
    coll = max(single, key=lambda c: c["roofline"]["collective_s"]
               / max(c["roofline"]["compute_s"], 1e-12))
    rep = next((c for c in single if c["arch"] == "dlrm-recross"), None)
    return {"worst_fraction": worst["cell"], "most_collective": coll["cell"],
            "paper_representative": rep["cell"] if rep else None}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("build", "dryrun"))
    ap.add_argument("--section", choices=["roofline", "dryrun", "pick"], default="roofline")
    args = ap.parse_args()
    cells = load_cells(args.dir)
    if args.section == "roofline":
        print(roofline_table(cells))
    elif args.section == "dryrun":
        print(dryrun_table(cells))
    else:
        print(json.dumps(pick_hillclimb_cells(cells), indent=1))


if __name__ == "__main__":
    main()
