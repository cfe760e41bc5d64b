"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The harness marks the measured window with ``record_function``
(``recbench.window``), and the program marks its own spans
(``repro_torch.core.trace``, on in a traced run).  From the profiler's
events this module takes, on the profiler's one clock:

* the window;
* every operation that ran on the card in it (kernels, copies, sets);
* the program's spans as the host ran them.

The profiler repeats the host's spans on the card's timeline; those are
not operations of the card, and are kept out of them.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

WINDOW = "recbench.window"
TOP = 10
#: the entry of :meth:`DeviceTrace.idle_gaps` that sums every name past the
#: first ``TOP - 1``
OTHER = "other"


@dataclasses.dataclass
class DeviceTrace:
    """Device operations and host spans of the traced window (seconds on
    the profiler's clock, each clipped to the window)."""

    window: tuple[float, float]
    ops: list[tuple[str, float, float]]          # (name, start, end)
    host: list[tuple[str, float, float]] = dataclasses.field(default_factory=list)

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

    def idle_gaps(self) -> list[list]:
        """The window's idle seconds (no operation on the card), each put
        down to the innermost host span open at the time, summed by the
        span's name, longest first; time outside every span is the
        window's.  At most :data:`TOP` entries: past ``TOP - 1`` names the
        last, :data:`OTHER`, holds the rest, so the entries sum to the
        window's idle seconds."""
        lo, hi = self.window
        busy = self.busy_intervals()
        # busy seconds from lo up to a time: linear between these points
        done = np.concatenate([[0.0], np.cumsum(busy[:, 1] - busy[:, 0])])
        xs = np.concatenate([[lo], busy.ravel(), [hi]])
        ys = np.concatenate([[0.0], np.column_stack([done[:-1], done[1:]]).ravel(), [done[-1]]])
        # span boundaries in time order: ends first, then starts, the
        # longer of two spans that start together first (it is the outer)
        events = sorted([(s, 1, s - e, i) for i, (_, s, e) in enumerate(self.host) if e > s]
                        + [(e, 0, 0.0, i) for i, (_, s, e) in enumerate(self.host) if e > s])
        times = np.array([lo] + [ev[0] for ev in events] + [hi])
        idle = np.diff(times) - np.diff(np.interp(times, xs, ys))
        total: dict[str, float] = collections.defaultdict(float)
        open_: list[int] = []
        for k, gap in enumerate(idle.tolist()):
            if gap > 0:
                total[self.host[open_[-1]][0] if open_ else WINDOW] += gap
            if k == len(events):
                break
            _, starts, _, i = events[k]
            if starts:
                open_.append(i)
            else:
                open_.remove(i)
        gaps = sorted(total.items(), key=lambda kv: -kv[1])
        if len(gaps) > TOP:
            gaps = gaps[:TOP - 1] + [(OTHER, sum(t for _, t in gaps[TOP - 1:]))]
        return [[n, t] for n, t in gaps]


def start(device: torch.device) -> torch.profiler.profile:
    """A profiler, started: on the card's activity too when ``device`` is one."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def read_events(events, spans) -> DeviceTrace:
    """The trace of ``events``, each ``(name, on_device, start_s, end_s)``.

    ``spans`` names the program's host spans.  On the host, the window and
    those spans are kept; on the device, every event but the window and
    those spans, which the profiler repeats there.
    """
    spans = set(spans)
    window = None
    ops, host = [], []
    for name, on_device, s, end in events:
        if on_device:
            if name not in spans and not name.startswith("recbench."):
                ops.append((name, s, end))
        elif name == WINDOW:
            window = (s, end)
        elif name in spans:
            host.append((name, s, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    lo, hi = window

    def clip(iv):
        return [(n, max(s, lo), min(e, hi)) for n, s, e in iv if e > lo and s < hi]

    return DeviceTrace(window, clip(ops), clip(host))


def stop(prof: torch.profiler.profile, spans=()) -> DeviceTrace:
    """Stops ``prof`` and reads its events (:func:`read_events`);
    ``spans`` names the program's spans."""
    prof.__exit__(None, None, None)
    cuda = torch.autograd.DeviceType.CUDA
    events = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        events.append((e.name(), e.device_type() == cuda, s, s + e.duration_ns() * 1e-9))
    return read_events(events, spans)
