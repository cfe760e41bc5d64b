"""Self-healing policy and failure accounting of the sharded serving
engine (DESIGN.md §8).

The policy half of ``repro.serve.faults``, verbatim: pure host code.

* :class:`RetryPolicy` — the self-healing knobs: bounded per-flush
  retries with exponential backoff + seeded jitter, offender bisection
  (split a repeatedly-failing batch and retry the halves, so one
  poisoned query is quarantined with its error instead of wedging its
  home), and a flush watchdog deadline that times out hung device work:
  a CPU server degrades the flush to the inline host/reference path, a
  CUDA server requeues its batch and raises :class:`FlushTimeout`.
  ``RetryPolicy.legacy()`` restores the pre-§8 requeue-and-re-raise
  contract.
* :class:`ErrorLedger` — the observability half: retries, backoff
  seconds, bisections, quarantined queries (with their errors),
  degraded / timed-out flushes, patch failures, recovery latency
  samples and the lost-work summary from :meth:`~repro_torch.serve.
  sharded.ShardedEmbeddingServer.close`, threaded through
  ``ShardedServeStats.summary()`` and ``report()``.
* :class:`FlushTimeout` — what the watchdog raises.

The injection half (``FaultSpec``, ``FaultPlan``, ``FaultInjector`` and
the ``Injected*`` errors) comes with the tiers and faults slice of the
port; until then the server refuses ``faults=``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.producers import DEFAULT_PRODUCER


class FlushTimeout(RuntimeError):
    """A flush exceeded the watchdog deadline (hung device work).  The
    watchdog fires identically for a real hang and a simulated one."""


def latency_percentiles(samples: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99 of a latency sample list (seconds; zeros when empty)."""
    if not samples:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    a = np.asarray(samples, dtype=np.float64)
    return {
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "p99": float(np.percentile(a, 99)),
    }


# --------------------------------------------------------- retry policy --


@dataclasses.dataclass
class RetryPolicy:
    """Self-healing knobs of the flush pipeline (DESIGN.md §8).

    Attributes:
      max_retries: in-place re-dispatch attempts per batch after the
        first failure (exponential backoff between attempts).  ``0``
        fails on first error.
      backoff_base / backoff_mult / backoff_max: retry *n* sleeps
        ``min(base · mult**n, max)`` seconds (before jitter).
      jitter: uniform multiplicative jitter fraction (a draw in
        ``[1-jitter, 1+jitter]``) from a ``seed``-ed generator, so two
        homes that fail together do not retry in lockstep — yet a
        replay is still deterministic.
      seed: the jitter RNG seed.
      bisect: after retries are exhausted on a batch of > 1 queries,
        split it and heal the halves independently — repeated failures
        converge on single offenders instead of wedging the home.
      quarantine: terminal failures of a single query are recorded in
        the :class:`ErrorLedger` (with the error) and the query is
        dropped; the home keeps serving.  ``False`` restores the legacy
        requeue-and-re-raise contract (the batch goes back to its home
        and the error surfaces at the next ``submit()``/``drain()``).
      watchdog_s: per-flush deadline measured from kernel dispatch; a
        flush not ready by then is timed out and, on a CPU server,
        degraded to the inline host/reference path; on a CUDA server its
        batch is requeued and :class:`FlushTimeout` raises (``None``
        disables the watchdog).
      watchdog_poll_s: readiness poll interval while waiting under the
        watchdog.
      patch_retries: barriers a failing staged patch is retried at
        before it is dropped (read by the drift/replan slice).
    """

    max_retries: int = 2
    backoff_base: float = 0.005
    backoff_mult: float = 2.0
    backoff_max: float = 0.25
    jitter: float = 0.25
    seed: int = 0
    bisect: bool = True
    quarantine: bool = True
    watchdog_s: Optional[float] = None
    watchdog_poll_s: float = 0.002
    patch_retries: int = 2

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        if self.watchdog_s is not None and self.watchdog_s <= 0:
            raise ValueError("watchdog_s must be positive (None disables)")

    @classmethod
    def parse(cls, policy) -> "RetryPolicy":
        """``None`` → defaults; a RetryPolicy passes through."""
        if policy is None:
            return cls()
        if isinstance(policy, RetryPolicy):
            return policy
        raise TypeError(f"retry must be a RetryPolicy, "
                        f"got {type(policy).__name__}")

    @classmethod
    def legacy(cls) -> "RetryPolicy":
        """The pre-§8 contract: first failure requeues the batch and
        re-raises at the caller — no retries, no bisection, no
        quarantine, no watchdog."""
        return cls(max_retries=0, bisect=False, quarantine=False)

    def backoff_s(self, attempt: int, rng: np.random.Generator) -> float:
        """Jittered exponential backoff before retry ``attempt`` (0-based)."""
        base = min(self.backoff_base * self.backoff_mult ** attempt,
                   self.backoff_max)
        if self.jitter:
            base *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return base


# ---------------------------------------------------------- error ledger --


@dataclasses.dataclass
class ErrorLedger:
    """Cumulative failure/recovery accounting of one server's lifetime,
    threaded through ``ShardedServeStats.summary()`` / ``report()``.

    ``recovery_s`` samples the time from a batch's FIRST failed dispatch
    attempt to its successful dispatch (healed transients only —
    quarantines are not recoveries).
    """

    retries: int = 0                      # re-dispatch attempts after failures
    backoff_s: float = 0.0                # Σ backoff slept between retries
    bisections: int = 0                   # batch splits hunting an offender
    quarantined: List[tuple] = dataclasses.field(
        default_factory=list
    )                                     # (table, local seq, error repr,
                                          #  producer label)
    degraded_flushes: int = 0             # served via the host path
    timed_out_flushes: int = 0            # watchdog firings
    patch_failures: int = 0               # staged-patch apply failures
    patches_dropped: int = 0              # … that exhausted patch_retries
    recovery_s: List[float] = dataclasses.field(default_factory=list)
    driver_errors_suppressed: int = 0     # stashed beyond the deque bound
    lost_work: Optional[Dict[str, int]] = None   # unserved at close()

    def quarantine(
        self, table: str, seq: int, err: BaseException, producer=None
    ) -> None:
        """Records one dropped query.  ``seq`` is the producer-LOCAL
        id; the error repr stays at index 2, with the producer label
        appended."""
        self.quarantined.append((
            table, int(seq), repr(err),
            DEFAULT_PRODUCER if producer is None else producer,
        ))

    def record_recovery(self, seconds: float) -> None:
        """Accounts one fault-to-healthy recovery interval."""
        self.recovery_s.append(seconds)

    def quarantined_keys(self) -> List[Tuple[str, int]]:
        """Producer-blind ``(table, local seq)`` pairs."""
        return sorted((q[0], q[1]) for q in self.quarantined)

    def quarantined_keys_by_producer(self) -> List[Tuple[object, str, int]]:
        """``(producer label, table, local seq)`` triples."""
        return sorted((q[3], q[0], q[1]) for q in self.quarantined)

    def summary(self) -> Dict[str, object]:
        """Failure/recovery counters for reports."""
        return {
            "retries": self.retries,
            "backoff_s": self.backoff_s,
            "bisections": self.bisections,
            "quarantined": [list(q[:3]) for q in self.quarantined],
            "quarantined_by_producer": [
                [str(q[3]), q[0], q[1]] for q in self.quarantined
            ],
            "degraded_flushes": self.degraded_flushes,
            "timed_out_flushes": self.timed_out_flushes,
            "patch_failures": self.patch_failures,
            "patches_dropped": self.patches_dropped,
            "recoveries": len(self.recovery_s),
            "recovery_latency_s": latency_percentiles(self.recovery_s),
            "driver_errors_suppressed": self.driver_errors_suppressed,
            "lost_work": self.lost_work,
        }
