"""CLI gate: ``python -m repro_torch.analysis [--strict] [--root DIR]``.

Runs the port's repo lint (:mod:`repro_torch.analysis.lint`) and the
static lock-discipline pass over ``repro_torch/serve``
(:mod:`repro_torch.analysis.races`) and prints every finding.  With
``--strict`` any finding makes the exit code 1; without it the report
is informational and the exit code is 0.  The runtime validators
(:mod:`repro_torch.analysis.invariants`) are not run here — they live
inside the serving stack behind ``RECROSS_VALIDATE=1``.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.races import BLESSED_LOCK_ORDER, analyze_locks


def main(argv=None) -> int:
    """Runs lint + static lock pass; returns the process exit code."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="ReCross port correctness tooling: repo lint + static "
                    "lock-discipline pass",
    )
    ap.add_argument(
        "--strict", action="store_true",
        help="exit 1 on any finding (the CI gate)",
    )
    ap.add_argument(
        "--root", default=None,
        help="repo root to lint (default: the installed tree)",
    )
    args = ap.parse_args(argv)

    lint_findings = run_lint(args.root)
    for f in lint_findings:
        print(f)

    report = analyze_locks()
    race_findings = report.findings()
    for msg in race_findings:
        print(f"[races] {msg}")

    n = len(lint_findings) + len(race_findings)
    locks = sum(len(v) for v in report.locks.values())
    edges = len({(e.held, e.acquired) for e in report.edges})
    print(
        f"repro_torch.analysis: {n} finding(s) — lint={len(lint_findings)}, "
        f"races={len(race_findings)} ({locks} locks, {edges} distinct "
        f"acquisition edges, blessed order: "
        f"{' -> '.join(BLESSED_LOCK_ORDER)})"
    )
    if n and args.strict:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
