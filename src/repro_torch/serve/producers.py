"""Per-producer sequence spaces for the multi-producer front door
(DESIGN.md §10).

The port of ``repro.serve.producers``, verbatim: pure host code.

The thread driver (§7.2) made ``submit()`` cheap — validate, stamp a
sequence id, enqueue — but the sequence id itself was a single global
per-table counter, which assumed exactly ONE producer thread.  Under N
concurrent producers a global counter forces either a lock-ordered
total order (whoever wins the lock owns the next row of every drain)
or torn stamps.  Production serving (RecNMP's many concurrent request
streams) wants neither: each stream needs FIFO over ITS OWN requests,
and the merge across streams must be deterministic — not an artifact
of thread scheduling.

This module is the whole of that contract:

* every producer owns a **sequence space**: a per-``(producer,
  table)`` local counter, advanced only by that producer's stamps;
* a stamped id packs ``(local_seq, producer_id)`` into one int —
  ``gseq = local_seq * SEQ_STRIDE + pid`` — so every downstream
  structure that already carried an int64 seq (scheduler pending
  entries, in-flight metadata, completed-chunk arrays, the drain
  argsort) carries the producer dimension for free;
* the **merge order** of a full drain is the numeric order of those
  packed ids: lexicographic ``(local_seq, producer_id)``.  Producer
  streams interleave round-robin by local position, ties broken by
  registration order — a pure function of what was submitted, never
  of how the OS scheduled the submitting threads;
* ``decode()`` recovers ``(producer label, local seq)`` — the fault
  injector's poison keying, the error ledger and the scheduler's
  per-producer accounting all speak decoded ids.

Registration is lazy (first stamp under an unseen label registers it)
but :meth:`ProducerRegistry.register` allows explicit pre-registration
when a test or bench wants pid order pinned independently of which
thread stamps first.
"""

from __future__ import annotations

import threading
from typing import Dict, Hashable, List, Optional, Tuple

#: packing stride of one sequence id: ``gseq = local_seq * SEQ_STRIDE +
#: producer_id``.  2**20 producers per server is far beyond any
#: plausible front door, and int64 still holds ~2**43 local seqs.
SEQ_STRIDE = 1 << 20

#: label a ``submit(producer=None)`` stamp registers under — the
#: single-producer path is just the default producer's sequence space
DEFAULT_PRODUCER = "default"


def producer_of(gseq: int, stride: int = SEQ_STRIDE) -> int:
    """Producer id of a packed sequence id."""
    return int(gseq) % stride


def local_seq_of(gseq: int, stride: int = SEQ_STRIDE) -> int:
    """Local (per-producer) sequence of a packed sequence id."""
    return int(gseq) // stride


class ProducerRegistry:
    """Thread-safe producer registration + per-space sequence stamping.

    Args:
      stride: the packing stride (tests shrink it to exercise the
        capacity guard; servers use :data:`SEQ_STRIDE`).

    All mutation happens under one internal lock; ``decode`` and the
    snapshot helpers read registration state that only ever grows, so
    a decode can never see a pid it cannot name.
    """

    def __init__(self, *, stride: int = SEQ_STRIDE):
        self.stride = int(stride)
        # lock order (DESIGN.md §5): innermost — acquired after any of
        # the server's three locks, never holds another lock inside
        self._lock = threading.Lock()
        self._pid: Dict[Hashable, int] = {}
        self._label: List[Hashable] = []
        # pid -> {table: next local seq}; one dict per registered space
        self._next: List[Dict[str, int]] = []

    # -------------------------------------------------------- registration --

    def register(self, producer: Optional[Hashable] = None) -> int:
        """Registers (or looks up) a producer label, returning its pid.

        Lazy registration means first-stamp order normally assigns
        pids; calling this up front pins them explicitly (the merge
        tiebreak is pid order, so benches that want a reproducible
        cross-producer interleave register before starting threads).
        """
        with self._lock:
            return self._register_locked(producer)

    def _register_locked(self, producer: Optional[Hashable]) -> int:
        label = DEFAULT_PRODUCER if producer is None else producer
        pid = self._pid.get(label)
        if pid is None:
            pid = len(self._label)
            if pid >= self.stride:
                raise RuntimeError(
                    f"producer capacity exhausted: {pid} registered "
                    f"spaces at stride {self.stride}"
                )
            self._pid[label] = pid
            self._label.append(label)
            self._next.append({})
        return pid

    # ------------------------------------------------------------ stamping --

    def stamp(self, producer: Optional[Hashable], table: str) -> int:
        """Stamps one submission: registers the producer if unseen,
        advances its (producer, table) local counter, returns the
        packed ``gseq``."""
        with self._lock:
            pid = self._register_locked(producer)
            space = self._next[pid]
            local = space.get(table, 0)
            # packed gseq = local * stride + pid must stay in int64:
            # past the boundary two submissions would alias the same
            # gseq and the drain merge would silently reorder
            if (local + 1) * self.stride > (1 << 63) - 1:
                raise OverflowError(
                    f"sequence capacity exhausted: local seq {local} at "
                    f"stride {self.stride} would overflow the packed gseq"
                )
            space[table] = local + 1
            return local * self.stride + pid

    def decode(self, gseq: int) -> Tuple[Hashable, int]:
        """``gseq -> (producer label, local seq)``.

        Ids this registry never stamped (raw ints handed straight to
        engine internals by tests/tools) decode as the default
        producer's rather than raising — their pid names no space.
        """
        pid = int(gseq) % self.stride
        if pid < len(self._label):  # unlocked: _label is append-only
            return self._label[pid], int(gseq) // self.stride  # unlocked: see above
        return DEFAULT_PRODUCER, int(gseq) // self.stride

    def pid(self, producer: Optional[Hashable]) -> Optional[int]:
        """pid of a label, ``None`` when it never registered."""
        label = DEFAULT_PRODUCER if producer is None else producer
        return self._pid.get(label)  # unlocked: _pid only ever grows

    def next_seq(self, table: str, producer: Optional[Hashable] = None) -> int:
        """Next LOCAL sequence the label would stamp on ``table`` (0
        for unregistered producers) — the test-facing counter view."""
        p = self.pid(producer)
        if p is None:
            return 0
        with self._lock:
            return self._next[p].get(table, 0)

    def reset_seqs(self) -> None:
        """Restarts every space's local counters (registrations — and
        therefore pids and the merge tiebreak — are kept).  Only legal
        fully quiesced: the server guards this exactly like the PR-5
        global reset, extended to every space at once."""
        with self._lock:
            for space in self._next:
                space.clear()

    # ------------------------------------------------------------ snapshot --

    def producers(self) -> List[Hashable]:
        """Registered labels in pid (registration) order."""
        return list(self._label)  # unlocked: _label is append-only

    def state(self) -> Dict[str, object]:
        """Report snapshot: labels + per-space next-seq counters."""
        with self._lock:
            return {
                "producers": [str(l) for l in self._label],
                "next_seq": {
                    str(self._label[p]): dict(space)
                    for p, space in enumerate(self._next) if space
                },
            }
