"""Deterministic fault injection, self-healing policy and failure
accounting of the sharded serving engine (DESIGN.md §8).

The port of ``repro.serve.faults``: pure host code.

* :class:`FaultPlan` / :class:`FaultInjector` — a seeded, deterministic
  fault-injection layer.  A plan is a list of :class:`FaultSpec`\\ s,
  each naming a seam of the engine (compile, kernel dispatch, device
  retire, patch apply), the attempt index at that seam on which the
  fault fires, and how many consecutive attempts it poisons.  The
  server consults the injector at exactly those seams, so the same plan
  and the same replay fire the same faults — on the reference's server
  and on this one, since :meth:`FaultPlan.random` draws the reference's
  plan for the same seed.
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

The injector never touches device state and injects *errors*, not
corruption: a "poisoned query" is a (table, seq) pair whose containing
batch always fails its compile seam (nothing names the offender;
bisection has to find it).  A simulated hang keeps a dispatched flush
"not ready" for its duration while its kernels run normally.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.producers import DEFAULT_PRODUCER


class FlushTimeout(RuntimeError):
    """A flush exceeded the watchdog deadline (hung device work).  Not
    an :class:`InjectedFault`: the watchdog fires identically for a real
    hang and a simulated one."""


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


# --------------------------------------------------------------- errors --


class InjectedFault(RuntimeError):
    """Base class of all injector-raised faults (so tests and the
    healing loop can tell injected chaos from real engine errors)."""


class InjectedCompileFault(InjectedFault):
    """Transient host-compile failure (e.g. an OOM during tracing)."""


class InjectedDeviceFault(InjectedFault):
    """Device-side failure, at dispatch or surfacing late at retire."""


class PoisonedQueryError(InjectedFault):
    """A batch containing a poisoned (table, seq) query failed.  The
    error deliberately does NOT name the offender — bisection must
    isolate it, as with a real undiagnosed poisoned batch."""


class InjectedPatchFault(InjectedFault):
    """A plan-patch image DMA / placement swap failure."""


#: seam names a :class:`FaultSpec` may target
KINDS = ("compile", "device", "device-late", "hang", "poison", "patch")


# ----------------------------------------------------------- fault plan --


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    Attributes:
      kind: the seam — ``"compile"`` (host compile raises), ``"device"``
        (kernel dispatch raises), ``"device-late"`` (the fault surfaces
        at retire, after the flush was dispatched), ``"hang"`` (the
        dispatched flush never reports ready until ``hang_s`` elapses —
        ``None`` hangs forever, the watchdog's job), ``"poison"`` (a
        specific (table, seq) query makes every batch containing it
        fail compile), ``"patch"`` (the staged plan patch fails to
        apply).
      tick: the 0-based attempt index AT THAT SEAM on which the fault
        starts firing (each seam keeps its own monotone attempt
        counter, so retries advance it deterministically).  Ignored for
        ``"poison"`` (keyed by (table, seq) instead).
      times: how many consecutive attempts fail (transient faults heal
        after ``times`` retries; poison is permanent regardless).
      table / seq: the poisoned query's table name and per-table
        submission sequence id (``"poison"`` only).  ``seq`` is the
        producer-LOCAL id (DESIGN.md §10) — what ``submit()`` number
        within that producer's stream is poisoned.
      producer: the poisoned query's producer label (``"poison"``
        only); ``None`` targets the default producer, so
        single-producer plans read exactly as before.
      hang_s: simulated hang duration in seconds (``"hang"`` only);
        ``None`` = forever.
    """

    kind: str
    tick: int = 0
    times: int = 1
    table: Optional[str] = None
    seq: Optional[int] = None
    producer: Optional[object] = None
    hang_s: Optional[float] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; use {KINDS}")
        if self.kind == "poison" and (self.table is None or self.seq is None):
            raise ValueError("poison faults need table= and seq=")
        if self.times < 1:
            raise ValueError("times must be >= 1")


class FaultPlan:
    """A deterministic, seeded schedule of :class:`FaultSpec`\\ s.

    Build one explicitly (``FaultPlan().add("compile", tick=2)``) or
    draw a random-but-reproducible schedule with :meth:`random`.  The
    plan is inert data; :class:`FaultInjector` gives it runtime state.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.seed = seed
        self.specs: List[FaultSpec] = list(specs)

    def add(self, kind: str, **kw) -> "FaultPlan":
        """Appends one fault spec; chainable."""
        self.specs.append(FaultSpec(kind, **kw))
        return self

    @classmethod
    def random(
        cls,
        seed: int,
        counts: Dict[str, int],
        *,
        horizon: int = 16,
        tables: Sequence[str] = (),
        max_seq: int = 64,
        times: int = 1,
        hang_s: Optional[float] = None,
        producers: Sequence = (),
    ) -> "FaultPlan":
        """Draws ``counts[kind]`` faults per kind with seam ticks
        uniform in ``[0, horizon)`` and poison targets uniform over
        ``producers × tables × [0, max_seq)`` — same seed, same
        schedule, drawn from the generator in the reference's order, so
        both servers replay the same plan.  An empty ``producers``
        targets the default producer.
        """
        rng = np.random.default_rng(seed)
        plan = cls(seed=seed)
        for kind in sorted(counts):
            n = counts[kind]
            if kind not in KINDS:
                raise ValueError(f"unknown fault kind {kind!r}; use {KINDS}")
            for _ in range(n):
                if kind == "poison":
                    if not tables:
                        raise ValueError("poison faults need tables=")
                    plan.add(
                        kind,
                        table=str(rng.choice(list(tables))),
                        seq=int(rng.integers(0, max(1, max_seq))),
                        **({"producer": list(producers)[
                                int(rng.integers(0, len(producers)))]}
                           if len(producers) else {}),
                    )
                else:
                    plan.add(
                        kind,
                        tick=int(rng.integers(0, max(1, horizon))),
                        times=times,
                        **({"hang_s": hang_s} if kind == "hang" else {}),
                    )
        return plan

    def poisoned(self) -> List[Tuple[str, int]]:
        """The (table, local seq) pairs this plan poisons (chaos
        benches use it to exclude exactly the offenders from the
        oracle).  Producer-blind — multi-producer chaos wants
        :meth:`poisoned_by_producer`."""
        return sorted(
            (s.table, s.seq) for s in self.specs if s.kind == "poison"
        )

    def poisoned_by_producer(self) -> List[Tuple[object, str, int]]:
        """``(producer label, table, local seq)`` poison triples;
        ``producer=None`` specs read as the default producer."""
        return sorted(
            (DEFAULT_PRODUCER if s.producer is None else s.producer,
             s.table, s.seq)
            for s in self.specs if s.kind == "poison"
        )

    def summary(self) -> Dict[str, object]:
        """Fault counts by kind plus the poisoned-key list."""
        by_kind: Dict[str, int] = {}
        for s in self.specs:
            by_kind[s.kind] = by_kind.get(s.kind, 0) + 1
        return {"seed": self.seed, "faults": by_kind,
                "poisoned": [list(p) for p in self.poisoned()]}


class FaultInjector:
    """Runtime half of a :class:`FaultPlan`: per-seam attempt counters
    plus the poison set, consulted by the server at each seam.

    Each seam keeps its own monotone attempt counter; a spec with
    ``tick=t, times=k`` fails attempts ``t .. t+k-1`` at that seam.
    All hooks run on whichever thread drives the engine (the caller
    inline, or the driver thread) — never concurrently.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._fail_at: Dict[str, Dict[int, FaultSpec]] = {
            k: {} for k in KINDS
        }
        for s in plan.specs:
            if s.kind == "poison":
                continue
            for t in range(s.tick, s.tick + s.times):
                self._fail_at[s.kind].setdefault(t, s)
        # poison keys are (table, producer label, LOCAL seq): the seq
        # decoder bound by the server unpacks the engine's packed ids;
        # unbound (standalone use), a seq is the default producer's
        self._poison = {
            (s.table,
             DEFAULT_PRODUCER if s.producer is None else s.producer,
             s.seq)
            for s in plan.specs if s.kind == "poison"
        }
        self._decode: Callable = lambda s: (DEFAULT_PRODUCER, int(s))
        self._attempts: Dict[str, int] = {k: 0 for k in KINDS}
        self.injected: Dict[str, int] = {k: 0 for k in KINDS}

    def bind_decoder(self, decode: Callable) -> None:
        """Installs the server's ``seq -> (producer, local seq)``
        decoder (DESIGN.md §10) so poison matching is producer-aware."""
        self._decode = decode

    @classmethod
    def parse(cls, faults) -> Optional["FaultInjector"]:
        """None | FaultPlan | FaultInjector → Optional[FaultInjector]."""
        if faults is None:
            return None
        if isinstance(faults, FaultInjector):
            return faults
        if isinstance(faults, FaultPlan):
            return cls(faults)
        raise TypeError(f"faults must be a FaultPlan or FaultInjector, "
                        f"got {type(faults).__name__}")

    def _due(self, seam: str) -> Optional[FaultSpec]:
        t = self._attempts[seam]
        self._attempts[seam] = t + 1
        spec = self._fail_at[seam].get(t)
        if spec is not None:
            self.injected[seam] += 1
        return spec

    # ------------------------------------------------------------- seams --

    def on_compile(self, entries: Sequence[Tuple[str, int, list]]) -> None:
        """Compile seam: raises for a poisoned batch (always) or a
        scheduled transient compile fault (this attempt).  Poison
        matching decodes each entry's packed seq — only the named
        producer's (table, local seq) fires, never another stream's
        query that happens to share the local id."""
        hit = [
            (t, s) for t, s, _q in entries
            if (t,) + self._decode(s) in self._poison
        ]
        if hit:
            self.injected["poison"] += 1
            raise PoisonedQueryError(
                f"injected: compile failed on a batch of {len(entries)}"
            )
        if self._due("compile") is not None:
            raise InjectedCompileFault("injected: transient compile failure")

    def on_dispatch(self) -> Optional[float]:
        """Dispatch seam: raises a scheduled device fault, else returns
        the simulated hang duration for this dispatch (``math.inf`` =
        forever; ``None`` = healthy)."""
        if self._due("device") is not None:
            raise InjectedDeviceFault("injected: device fault at dispatch")
        spec = self._fail_at["hang"].get(self._attempts["hang"])
        self._attempts["hang"] += 1
        if spec is None:
            return None
        self.injected["hang"] += 1
        return math.inf if spec.hang_s is None else float(spec.hang_s)

    def on_retire(self) -> None:
        """Retire seam: a device fault surfacing only when the flush's
        outputs are handed off (the late-detection case)."""
        if self._due("device-late") is not None:
            raise InjectedDeviceFault("injected: device fault at retire")

    def on_patch(self) -> None:
        """Patch-apply seam: the staged-plan image DMA fails."""
        if self._due("patch") is not None:
            raise InjectedPatchFault("injected: plan patch apply failure")

    def summary(self) -> Dict[str, object]:
        """Plan summary plus per-seam attempt/injection counters."""
        return {
            "plan": self.plan.summary(),
            "attempts": dict(self._attempts),
            "injected": dict(self.injected),
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
        disables the watchdog, though an *injected* infinite hang still
        times out rather than blocking forever).
      watchdog_poll_s: readiness poll interval while waiting under the
        watchdog.
      patch_retries: barriers a failing staged patch is retried at
        before it is dropped (the server keeps serving under the live
        plan; the drop is recorded).
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
