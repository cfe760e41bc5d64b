"""Spans and counters of the serve path, the plan build and the DLRM
forward (``RECROSS_TRACE``).

One process-wide switch, read once from ``RECROSS_TRACE`` (any non-empty
value turns it on) and set by :func:`set_enabled`.

* Off, :func:`span` returns one shared no-op context and :func:`count`
  returns at once: an instrumented path pays one flag check a call.
* On, a span adds its ``perf_counter`` seconds and one call to the
  totals under ``name``, and while a profiler is active it enters
  ``torch.profiler.record_function(name, args)``, so it lands in the
  trace on the clock of the card's kernels and copies (outside a
  profiler that call would record nothing, at a cost); a counter adds to
  its total.

There is no exporter: the profiler's trace is the timeline, and
:func:`totals` is the reading.  The names, each where its work happens:

========================  ====================================================
``serve.request``         ``ShardedEmbeddingServer.serve``, args: the
                          server's request number
``serve.compile``         the host compile of a request; its seconds are
                          ``report()["serve"]["host_compile_s"]``'s, and
                          the ``compile.*`` spans run inside it
``compile.activations``   ``compile_activations``, in the server's
                          ``_compile_batch`` and in ``compile_queries``
                          (one a table)
``compile.bitmaps``       the dense ``tile_ids``/``bitmaps`` fill in
                          ``compile_queries`` (one a table; not on the
                          serve path)
``compile.concat``        ``concat_compiled_queries``: per-table dense
                          compiles padded and concatenated (not on the
                          serve path)
``compile.shard_block``   ``shard_block_activations`` (rebase, union,
                          slots and the ones' flat indices) or
                          ``shard_block_queries``, up to the upload
``compile.upload``        the schedule's host-to-device copy, pinned and
                          enqueued non-blocking, and, in
                          ``shard_block_activations``, the previous
                          batch's ones cleared and this batch's set on
                          the device
``serve.dispatch``        the kernel launches, casts, shard sum and
                          per-table slices of a batch
``serve.wait``            the host blocked on the card's event
``plan.cooccurrence``     ``build_cooccurrence`` (one a table)
``plan.grouping``         ``correlation_aware_grouping`` (one a table)
``plan.replication``      ``plan_replication`` and ``build_layout`` (one a
                          table)
``plan.placement``        ``plan_shards`` (once a build)
``plan.image``            the fused image, the shard images and their copy
                          to the device (once a build)
``model.bottom``          ``models.dlrm.dlrm_forward``'s bottom MLP (one a
                          forward)
``model.interaction``     its dot interaction or low-rank cross network
                          (one a forward)
``model.top``             its top MLP (one a forward)
========================  ====================================================

Counters: ``h2d_bytes`` (every host-to-device copy
``core.reduction._to_device`` issues), ``expand_entries`` (the ones
``shard_block_activations`` sets in a bitmap on a CUDA device), ``slots``
(non-padding ``(shard, block, tile)`` slots dispatched), ``read_slots`` (those the
crossbar kernel takes down its READ path: the switch on and at most one
nonzero bitmap entry across the slot's ``q_block × tile_rows``; for
``q_block`` above 16 the kernel decides per 16-query chunk, and the count
is a lower bound) and ``mac_ones`` (the nonzero bitmap entries that the
other slots, the MAC path's, sum: at most ``q_block × tile_rows`` a
slot).  The slot counts cost host work and are made only while tracing
is on.
"""

from __future__ import annotations

import os
import threading
import time

import torch

TRACE_ENV = "RECROSS_TRACE"

_enabled = bool(os.environ.get(TRACE_ENV))
_lock = threading.Lock()
#: name -> [seconds, calls]
_spans: dict[str, list] = {}
#: name -> total
_counters: dict[str, int] = {}


def enabled() -> bool:
    """True while tracing is on."""
    return _enabled


def set_enabled(on: bool) -> None:
    """Turns tracing on or off for the whole process."""
    global _enabled
    _enabled = bool(on)


def reset() -> None:
    """Clears the totals."""
    with _lock:
        _spans.clear()
        _counters.clear()


def totals() -> dict:
    """A copy of the totals: ``{"spans": {name: [seconds, calls]},
    "counters": {name: value}}``."""
    with _lock:
        return {"spans": {k: list(v) for k, v in _spans.items()},
                "counters": dict(_counters)}


class _Off:
    """The shared span of tracing off: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def record(self, seconds: float) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("_name", "_args", "_rf", "_t0", "_seconds")

    def __init__(self, name: str, args):
        self._name = name
        self._args = None if args is None else str(args)
        self._seconds = None

    def __enter__(self):
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self._name, self._args)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def record(self, seconds: float) -> None:
        """Counts ``seconds``, timed by the caller, in place of the span's
        own clock: a span whose total has to equal another counter's."""
        self._seconds = seconds

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0 if self._seconds is None else self._seconds
        if self._rf is not None:
            self._rf.__exit__(*exc)
        with _lock:
            total = _spans.setdefault(self._name, [0.0, 0])
            total[0] += dt
            total[1] += 1
        return False


def span(name: str, args=None):
    """A context that marks ``name`` while tracing is on (``args`` goes to
    ``record_function`` as a string), and does nothing while it is off."""
    return _Span(name, args) if _enabled else _OFF


def count(name: str, n: int) -> None:
    """Adds ``n`` to counter ``name`` while tracing is on."""
    if _enabled:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)
