"""Per-stage progress for long plan builds (``RECROSS_PLAN_PROGRESS``).

A 10M-row plan build runs for tens of seconds per stage; with nothing on
the terminal it is indistinguishable from a hang.  When the
``RECROSS_PLAN_PROGRESS`` env var is set (any non-empty value), the
long-running stages — co-occurrence blocks, the grouping seed walk,
shard placement — emit throttled one-line reports to stderr:

    [plan] grouping  3276800/10000000 rows  32.8%  812.3k rows/s

The emitter is deliberately dumb: callers own the unit ("rows",
"pairs", "groups"), ticks are throttled by wall time so a tick per
CSR block or per seed chunk costs one time() call, and the whole thing
is a no-op object when the env var is unset so hot loops pay a single
attribute check.  Benches surface the same per-stage wall time and
rows/s through their JSON spreads; this knob is for interactive runs.
"""

from __future__ import annotations

import os
import sys
import time

PROGRESS_ENV = "RECROSS_PLAN_PROGRESS"

#: minimum seconds between emitted lines
_INTERVAL_S = 0.5


def plan_progress_enabled() -> bool:
    """True when ``RECROSS_PLAN_PROGRESS`` is set non-empty."""
    return bool(os.environ.get(PROGRESS_ENV))


class StageProgress:
    """Throttled progress reporter for one pipeline stage.

    Args:
      stage: short stage label (``"grouping"``, ``"cooc"``...).
      total: total work units, or 0 when unknown (rate-only lines).
      unit: unit label for the report lines.
      enabled: overrides the env check (benches force-enable).
    """

    def __init__(
        self,
        stage: str,
        total: int = 0,
        unit: str = "rows",
        enabled: bool | None = None,
    ):
        self.enabled = plan_progress_enabled() if enabled is None else bool(enabled)
        self.stage = stage
        self.total = int(total)
        self.unit = unit
        self._t0 = time.perf_counter()
        self._last = self._t0

    def tick(self, done: int) -> None:
        """Report ``done`` units complete (throttled; safe to call often)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self._last < _INTERVAL_S:
            return
        self._last = now
        self._emit(done, now)

    def finish(self, done: int) -> float:
        """Final report; returns the stage wall time in seconds."""
        now = time.perf_counter()
        if self.enabled:
            self._emit(done, now, final=True)
        return now - self._t0

    def _emit(self, done: int, now: float, final: bool = False) -> None:
        dt = max(now - self._t0, 1e-9)
        rate = done / dt
        pct = f"  {100.0 * done / self.total:5.1f}%" if self.total else ""
        tail = "  done" if final else ""
        print(
            f"[plan] {self.stage:<10s} {done}/{self.total or '?'} "
            f"{self.unit}{pct}  {rate / 1e3:.1f}k {self.unit}/s"
            f"  {dt:.1f}s{tail}",
            file=sys.stderr,
            flush=True,
        )
