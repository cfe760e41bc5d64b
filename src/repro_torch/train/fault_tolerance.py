"""Fault-tolerance runtime: heartbeats, stragglers, elastic re-meshing.

A copy of ``repro.train.fault_tolerance`` (host Python, no tensors).

What actually runs on a 1000-node fleet and what is represented here:

  * **Heartbeat monitor** — every host appends ``(host, step, t)`` records;
    the monitor flags hosts whose last beat is older than ``timeout``.
    In production the transport is the cluster scheduler / etcd; here it
    is an in-process store with the same interface, unit-tested against
    simulated failures.
  * **Straggler mitigation** — per-step duration tracking with a robust
    z-score; hosts slower than ``threshold × median`` over a window are
    flagged for eviction (the data pipeline's statelessness makes eviction
    cheap: survivors re-derive the failed host's shard from seed+step).
  * **Elastic re-mesh** — on membership change, :func:`plan_remesh`
    computes the new mesh shape (largest (data × model) grid that fits
    the survivors, model axis preserved) and the restore path re-shards
    the last committed checkpoint onto it (checkpoint.restore handles the
    re-placement).
  * **Restart loop** — :func:`run_with_restarts` wraps a step function,
    catches failures, restores the latest checkpoint, and resumes; used
    by the end-to-end example and tested with injected faults.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class HeartbeatMonitor:
    timeout_s: float = 60.0
    _last: Dict[int, Tuple[int, float]] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, step: int, t: Optional[float] = None) -> None:
        self._last[host] = (step, t if t is not None else time.time())

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [h for h, (_, t) in self._last.items() if now - t > self.timeout_s]

    def membership(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return sorted(h for h, (_, t) in self._last.items() if now - t <= self.timeout_s)


@dataclasses.dataclass
class StragglerDetector:
    window: int = 32
    threshold: float = 2.0
    _durations: Dict[int, List[float]] = dataclasses.field(default_factory=dict)

    def record(self, host: int, duration_s: float) -> None:
        self._durations.setdefault(host, []).append(duration_s)
        if len(self._durations[host]) > self.window:
            self._durations[host].pop(0)

    def stragglers(self) -> List[int]:
        if not self._durations:
            return []
        meds = {h: float(np.median(d)) for h, d in self._durations.items() if d}
        overall = float(np.median(list(meds.values())))
        if overall <= 0:
            return []
        return sorted(h for h, m in meds.items() if m > self.threshold * overall)


def plan_remesh(
    n_hosts: int,
    chips_per_host: int,
    *,
    model_parallelism: int,
    pods: int = 1,
) -> Tuple[int, ...]:
    """Largest (pods, data, model) grid on the surviving chips.

    The model axis is preserved (params were sharded for that TP degree);
    data parallelism absorbs the loss.  Raises if fewer chips than one
    model replica remain.
    """
    chips = n_hosts * chips_per_host
    per_pod = chips // pods
    data = per_pod // model_parallelism
    if data < 1:
        raise RuntimeError(
            f"cannot re-mesh: {chips} chips < model_parallelism {model_parallelism}"
        )
    if pods > 1:
        return (pods, data, model_parallelism)
    return (data, model_parallelism)


def run_with_restarts(
    step_fn: Callable[[int, object], object],
    init_state: object,
    num_steps: int,
    *,
    save_fn: Callable[[int, object], None],
    restore_fn: Callable[[], Tuple[int, object]],
    save_every: int = 10,
    max_restarts: int = 5,
) -> Tuple[object, Dict]:
    """Drives step_fn with checkpoint/restart on any exception.

    Returns (final_state, stats) where stats counts restarts and replayed
    steps — the integration test injects faults and asserts the final
    state matches an uninterrupted run (determinism contract).
    """
    stats = {"restarts": 0, "replayed_steps": 0}
    state = init_state
    step = 0
    restarts = 0
    while step < num_steps:
        try:
            state = step_fn(step, state)
            step += 1
            if step % save_every == 0 or step == num_steps:
                save_fn(step, state)
        except Exception:
            restarts += 1
            stats["restarts"] = restarts
            if restarts > max_restarts:
                raise
            restored_step, state = restore_fn()
            stats["replayed_steps"] += step - restored_step if step > restored_step else 0
            step = restored_step
    return state, stats
