"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The harness marks the measured window with ``record_function``
(``recbench.window``).  From the profiler's events this module takes the
window and every operation that ran on the card in it (kernels, copies,
sets), on the profiler's one clock.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

WINDOW = "recbench.window"
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    """Device operations of the traced window (seconds on the profiler's
    clock, operations clipped to the window)."""

    window: tuple[float, float]
    ops: list[tuple[str, float, float]]          # (name, start, end)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> np.ndarray:
        """The union of the operations' intervals, as sorted ``(n, 2)``."""
        if not self.ops:
            return np.empty((0, 2))
        iv = np.array(sorted((s, e) for _, s, e in self.ops))
        merged = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return np.array(merged)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) if iv.size else 0.0

    def op_seconds(self, match: str) -> float:
        """Device seconds of the operations whose name holds ``match``."""
        return sum(e - s for name, s, e in self.ops if match in name)

    def device_ops(self) -> list[list]:
        """The operations that took the most time, summed by name."""
        total: dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.ops:
            total[name] += e - s
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def start(device: torch.device) -> torch.profiler.profile:
    """A profiler, started: on the card's activity too when ``device`` is one."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def stop(prof: torch.profiler.profile) -> DeviceTrace:
    """Stops ``prof`` and reads the window and the device operations from
    its events."""
    prof.__exit__(None, None, None)
    window = None
    ops = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns() * 1e-9
        end = s + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the profiler repeats the host spans on the device's timeline
            if not name.startswith("recbench."):
                ops.append((name, s, end))
        elif name == WINDOW:
            window = (s, end)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    lo, hi = window
    ops = [(n, max(s, lo), min(e, hi)) for n, s, e in ops if e > lo and s < hi]
    return DeviceTrace(window, ops)
