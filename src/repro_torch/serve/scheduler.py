"""Shard-aware flush scheduling for the sharded embedding server.

The port of ``repro.serve.scheduler``, verbatim: pure host bookkeeping
over the port's :class:`~repro_torch.dist.shard_plan.ShardPlan`.

The policy half of the asynchronous serving engine (DESIGN.md §7).  The
global flush path (PR 2/3) batches every table into one fused compile:
every shard waits for the slowest table's block union to fill, and the
host compiles flush *n+1* only after flush *n* returns.  This module
decides *which queries can flush together early*:

  * **routing** — a query's sharded-once groups pin it to their owner
    shards.  A query whose owners collapse to one shard (or whose groups
    are all replicated-everywhere) is servable by a *single* shard: that
    shard holds every tile the query activates, so its reduction
    completes with no cross-shard combine at all.  Multi-owner queries
    route by their frozen **owner set**: under ``"owner-set"`` each
    distinct set is its own home — ``take()`` returns exactly that set
    as flush participants, so a 2-owner query on an 8-shard mesh
    compiles (and combines over) a 2-shard subset instead of waiting in
    a near-mesh-wide pool; under ``"per-shard"``/``"deadline"`` they
    collapse into the single :data:`POOL` home, flushed over the union
    of its queries' owners (the PR-4 behavior).
  * **union-fill accounting** — one
    :class:`~repro_torch.core.reduction.BlockUnionTracker` per (home, table)
    maintains the grid a flush-now would run, without compiling
    anything (per table because the fused compile's blocks never span
    tables; a home's fill is the sum over its tables).  A home flushes
    independently when its union fill crosses ``union_budget``, when its
    pending count reaches ``batch_size``, or — whenever the policy
    carries a ``deadline`` — when its oldest query has waited
    ``deadline`` submissions.

A *home* is therefore either an ``int`` (one shard: single-owner and
replicated-only queries), the :data:`POOL` sentinel, or a sorted
``tuple`` of shard ids (an owner-set home).  Owner-set homes are
created lazily as sets are first seen; the population is bounded by the
distinct owner sets in the traffic, not ``2^S`` (skewed production
traffic concentrates on few sets, and the deadline bound keeps any
cold set from waiting unboundedly).

The scheduler is pure host bookkeeping — it never touches device state.
Dispatch, the bounded in-flight queue and the double-buffered
host-compile / device-execute pipelining live in
:class:`repro_torch.serve.sharded.ShardedEmbeddingServer`; the
patch-barrier rule for online replanning (a staged plan patch applies
only when the pipeline is drained) is specified in DESIGN.md §7.3.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.reduction import BlockUnionTracker
from repro_torch.serve.producers import DEFAULT_PRODUCER

#: pseudo-home for pooled multi-owner queries, flushed over their owner
#: union: all of them under ``per-shard`` / ``deadline``, only those
#: whose owner set exceeds ``owner_set_max`` under ``owner-set``
POOL = -1

_KINDS = ("global", "per-shard", "deadline", "owner-set")


@dataclasses.dataclass
class FlushPolicy:
    """When does a pending query batch flush, and how deep may the
    dispatch pipeline run (DESIGN.md §7.1).

    Attributes:
      kind: ``"global"`` — the PR-2 synchronous path (one fused flush at
        ``batch_size`` buffered, blocking serve); ``"per-shard"`` —
        shards flush independently on their own union-fill /
        batch-size triggers, multi-owner queries pool into one
        :data:`POOL` home; ``"deadline"`` — per-shard plus a default
        age bound so a query on a cold shard can never wait
        unboundedly; ``"owner-set"`` — multi-owner queries route to a
        home per frozen owner set and flush over exactly that subset
        (deadline defaults on, since owner-set homes fragment the
        pending stream and cold sets would otherwise starve).
      batch_size: per-home pending-query trigger (defaults to the
        server's ``batch_size``).
      union_budget: per-home block-union fill trigger (Σ union widths
        the pending stream would DMA); ``None`` disables the fill
        trigger and leaves batch-size/deadline only.
      deadline: max submissions (global ticks) the oldest pending query
        of a home may wait before a forced flush; consulted whenever
        set, on any async kind.  ``parse`` defaults it to
        ``4 × batch_size`` for the ``deadline`` and ``owner-set`` kinds
        and leaves it ``None`` (trigger off) for ``per-shard``.
      deadline_s: max WALL-CLOCK seconds the oldest pending query of a
        home may wait before a forced flush (``None`` = trigger off).
        The tick deadline bounds waiting in *submissions*, which under
        an open-loop arrival process is rate-independent — a home on a
        quiet stream can still hold a query for an arbitrarily long
        wall time.  A wall deadline is what an SLO actually bounds.
        Only the thread driver can FIRE it while traffic is idle (its
        idle loop services due homes); the inline engine consults it at
        submit/flush boundaries only.
      owner_set_max: (``owner-set`` kind) owner sets LARGER than this
        collapse into the :data:`POOL` home instead of getting their
        own.  The subset-flush win scales with how far an owner set
        falls short of the mesh, while fragmentation cost grows with
        the distinct-set population (which peaks at sets of size
        ``S/2``) — a cap of 2-3 keeps the high-value small-set homes
        and pools the near-mesh tail.  ``None`` (default) keys every
        multi-owner set.
      max_in_flight: bound on dispatched-but-unretired flushes; the
        oldest blocks (``block_until_ready``) when the bound is hit —
        with the inline driver that block happens inside ``submit()``,
        with the thread driver it happens on the driver thread.
      threaded: run the engine's dispatch/retire loop on a driver
        thread (DESIGN.md §7.2): ``submit()`` only validates, stamps a
        sequence id and enqueues onto a bounded hand-off queue — it
        never blocks on a full in-flight pipeline.
      handoff_depth: bound of the thread driver's hand-off queue
        (defaults to ``8 × batch_size``); the producer blocks only if
        it outruns the driver by this many undispatched queries.
    """

    kind: str = "global"
    batch_size: int | None = None
    union_budget: int | None = None
    deadline: int | None = None
    deadline_s: float | None = None
    owner_set_max: int | None = None
    max_in_flight: int = 2
    threaded: bool = False
    handoff_depth: int | None = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown flush policy {self.kind!r}; use {_KINDS}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive (None = trigger off)")
        if self.max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if self.threaded and self.kind == "global":
            raise ValueError("the thread driver requires an async kind")
        if self.owner_set_max is not None and self.owner_set_max < 2:
            raise ValueError("owner_set_max must be >= 2 (a 1-owner query "
                             "already routes to its single owner shard)")

    @classmethod
    def parse(cls, policy, *, batch_size: int) -> "FlushPolicy":
        """Normalizes a kind string (or a ready policy) against server
        defaults: ``batch_size`` falls back to the server's, ``deadline``
        to ``4 × batch_size`` (``deadline`` / ``owner-set`` kinds), the
        hand-off bound to ``8 × batch_size``."""
        if isinstance(policy, str):
            policy = cls(kind=policy)
        p = dataclasses.replace(policy)
        if p.batch_size is None:
            p.batch_size = batch_size
        if p.kind in ("deadline", "owner-set") and p.deadline is None:
            p.deadline = 4 * p.batch_size
        if p.handoff_depth is None:
            p.handoff_depth = 8 * p.batch_size
        return p

    @property
    def is_async(self) -> bool:
        """True for every policy but the synchronous ``"global"``."""
        return self.kind != "global"

    @property
    def owner_set_routing(self) -> bool:
        """True when flush homes are owner-set tuples, not shards."""
        return self.kind == "owner-set"


#: a flush home: one shard (int), the :data:`POOL` sentinel, or a
#: sorted owner-set tuple (``owner-set`` routing)
Home = object


class FlushScheduler:
    """Routes queries to flush homes and tracks per-home fill state.

    One *home* per shard (single-owner and replicated-only queries) plus
    either the :data:`POOL` home (pooled kinds) or one lazily-created
    home per distinct frozen owner set (``owner-set`` kind) for
    multi-owner queries.  All state is host NumPy/sets; ``route``/
    ``push`` are O(rows in the query).

    Args:
      plan: the live :class:`~repro_torch.dist.shard_plan.ShardPlan` (only
        ``num_shards`` / ``shard_of_group`` / ``tables`` are read).
      layouts: per-table :class:`~repro_torch.core.mapping.CrossbarLayout` in
        the same (sorted-name) order as ``plan.tables``.
      names: table names in that order.
      q_block: the server's query block size (union accounting unit).
      policy: a normalized :class:`FlushPolicy`.
      seq_decode: ``seq -> (producer label, local seq)`` decoder for
        the packed per-producer sequence ids (DESIGN.md §10) — feeds
        the per-producer accounting in :meth:`state`.  ``None`` treats
        every seq as the default producer's (raw local ids).
    """

    def __init__(self, plan, layouts, names: Sequence[str], q_block: int,
                 policy: FlushPolicy,
                 seq_decode: Optional[Callable] = None):
        self.q_block = q_block
        self.policy = policy
        self.names = list(names)
        self._seq_decode = (
            seq_decode if seq_decode is not None
            else (lambda s: (DEFAULT_PRODUCER, int(s)))
        )
        #: cumulative pushes per producer label (per-producer share of
        #: the routed stream; pending_by_producer in :meth:`state` is
        #: the instantaneous complement)
        self.pushed_by_producer: Dict[str, int] = {}
        self._group_of = {
            name: np.asarray(layout.group_of, dtype=np.int64)
            for name, layout in zip(self.names, layouts)
        }
        self.rebuild(plan)
        # POOL exists under every async kind: the pooled kinds route all
        # multi-owner queries there, owner-set routing only those whose
        # sets exceed ``owner_set_max`` (never, when the cap is unset)
        homes: List[Home] = list(range(self.num_shards)) + [POOL]
        self._pending: Dict[Home, List[Tuple[str, int, list]]] = {
            h: [] for h in homes
        }
        # one tracker per (home, table): the fused compile never lets a
        # block span tables, so per-table block accounting is what the
        # flush would actually run; a home's fill sums over its tables
        self._trackers: Dict[Home, Dict[str, BlockUnionTracker]] = {
            h: {} for h in homes
        }
        self._first_tick: Dict[Home, int] = {}
        # wall-clock twin of _first_tick, for the deadline_s trigger
        self._first_wall: Dict[Home, float] = {}
        self._tick = 0
        self._rr = 0
        self._pool_owners: set = set()
        #: failure-path accounting (DESIGN.md §8): batches put back by a
        #: failed dispatch, and queries permanently dropped after
        #: offender bisection isolated them
        self.requeues = 0
        self.quarantined = 0

    # ------------------------------------------------------------ routing --

    def rebuild(self, plan) -> None:
        """Re-derives the routing tables from a (possibly patched) plan.

        Called at build and after every applied plan patch — promotion /
        demotion changes group ownership, so row→home routing must
        follow.  Only legal when nothing is pending (the patch-barrier
        rule guarantees it: pending work flushed under the old plan
        before the patch applies).
        """
        self.num_shards = int(plan.num_shards)
        shard_of_group = np.asarray(plan.shard_of_group, dtype=np.int64)
        self._owner_of_row = {}
        self._fused_group_of_row = {}
        for seg in plan.tables:
            gof = self._group_of[seg.name] + seg.group_offset
            self._fused_group_of_row[seg.name] = gof
            self._owner_of_row[seg.name] = shard_of_group[gof]

    def route(self, table: str, query: Sequence[int]) -> Tuple[Home, np.ndarray]:
        """Home of one query + its distinct fused group ids (a PEEK —
        does not advance the replicated-work round robin; only
        :meth:`push` consumes a round-robin slot).

        Owners = owning shards of the query's sharded-once groups:
        none → any shard serves it (round-robin keeps replicated work
        spread, the degenerate form of the block-level round robin);
        one → that shard; several → the sorted owner-set tuple under
        ``owner-set`` routing, else the cross-shard :data:`POOL`.
        """
        home, groups, _ = self._route(table, query, advance=False)
        return home, groups

    def _route(
        self, table: str, query, *, advance: bool
    ) -> Tuple[Home, np.ndarray, np.ndarray]:
        rows = np.unique(np.asarray(query, dtype=np.int64))
        groups = np.unique(self._fused_group_of_row[table][rows])
        owners = np.unique(self._owner_of_row[table][rows])
        if owners.size and owners[0] == -2:
            # COLD sentinel (repro_torch.dist.shard_plan): no shard holds the
            # tile, so no flush home can serve it — the server must have
            # detoured this query to its host fetch queue before routing
            raise ValueError(
                f"query on table {table!r} touches a cold (host-tier) "
                "group; cold queries take the host path, not a flush home"
            )
        owners = owners[owners >= 0]
        if owners.size == 0:
            home: Home = self._rr
            if advance:
                self._rr = (self._rr + 1) % self.num_shards
        elif owners.size == 1:
            home = int(owners[0])
        elif (self.policy.owner_set_routing
              and (self.policy.owner_set_max is None
                   or owners.size <= self.policy.owner_set_max)):
            # np.unique already sorted the owners: the tuple is the
            # canonical frozen owner set, one home per distinct set.
            # Sets wider than owner_set_max fall through to the pool —
            # the subset win shrinks as a set approaches the mesh while
            # home fragmentation grows, so the tail is not worth keying.
            home = tuple(int(o) for o in owners)
        else:
            home = POOL
        return home, groups, owners

    def push(self, table: str, seq: int, query: Sequence[int]) -> Home:
        """Routes and enqueues one query; returns its home (owner-set
        homes are created lazily on first sight)."""
        home, groups, owners = self._route(table, query, advance=True)
        if home == POOL:
            self._pool_owners.update(int(o) for o in owners)
        label = str(self._seq_decode(seq)[0])
        self.pushed_by_producer[label] = (
            self.pushed_by_producer.get(label, 0) + 1
        )
        self._pending.setdefault(home, []).append((table, seq, list(query)))
        self._trackers.setdefault(home, {}).setdefault(
            table, BlockUnionTracker(self.q_block)
        ).add(groups)
        self._first_tick.setdefault(home, self._tick)
        self._first_wall.setdefault(home, time.monotonic())
        self._tick += 1
        return home

    def first_tick(self, home: Home):
        """Submission tick of the home's oldest pending query (None if
        empty) — captured by the server before a flush so a failed
        dispatch can requeue without resetting the deadline clock."""
        return self._first_tick.get(home)

    def first_wall(self, home: Home):
        """Wall-clock (``time.monotonic``) twin of :meth:`first_tick`,
        captured/restored for the same requeue reason when the policy
        carries a ``deadline_s``."""
        return self._first_wall.get(home)

    def requeue(
        self,
        home: Home,
        entries: List[Tuple[str, int, list]],
        first_tick: int | None = None,
        first_wall: float | None = None,
    ) -> None:
        """Puts a taken batch back at the FRONT of its home's queue.

        The failed-dispatch retry path: a compile error (e.g. one
        malformed query) must not drop the batch — the async analogue
        of the sync flush's leave-buffered-on-failure contract.  The
        fill trackers and (for the pool) the owner union rebuild from
        the merged queue so a later flush compiles correctly, and
        ``first_tick`` (captured before the take) restores the deadline
        clock so surviving queries never wait past the policy bound.
        """
        if not entries:
            return
        self.requeues += 1
        self._pending[home] = list(entries) + self._pending.get(home, [])
        self._trackers[home] = {}
        for table, _seq, query in self._pending[home]:
            rows = np.unique(np.asarray(query, dtype=np.int64))
            self._trackers[home].setdefault(
                table, BlockUnionTracker(self.q_block)
            ).add(np.unique(self._fused_group_of_row[table][rows]))
            if home == POOL:
                owners = np.unique(self._owner_of_row[table][rows])
                self._pool_owners.update(
                    int(o) for o in owners if o >= 0
                )
        if first_tick is not None:
            self._first_tick[home] = min(
                first_tick, self._first_tick.get(home, first_tick)
            )
        else:
            self._first_tick.setdefault(home, self._tick)
        if first_wall is not None:
            self._first_wall[home] = min(
                first_wall, self._first_wall.get(home, first_wall)
            )
        else:
            self._first_wall.setdefault(home, time.monotonic())

    def record_quarantine(self, n: int) -> None:
        """Counts ``n`` queries permanently dropped by the server's
        offender bisection (they were already taken, so there is no
        pending state to unwind — this is pure accounting)."""
        self.quarantined += int(n)

    # ----------------------------------------------------------- triggers --

    def due_reason(self, home: Home) -> str | None:
        """Why ``home`` should flush now (``None`` = not due).

        Returns ``"batch"`` (pending count), ``"union"`` (block-union
        fill crossed the budget) or ``"deadline"`` (oldest pending query
        aged out — checked whenever the policy carries a deadline),
        in that order.
        """
        n = len(self._pending[home])
        if n == 0:
            return None
        if n >= self.policy.batch_size:
            return "batch"
        if (self.policy.union_budget is not None
                and self.fill(home) >= self.policy.union_budget):
            return "union"
        if (self.policy.deadline is not None
                and self._tick - self._first_tick[home] >= self.policy.deadline):
            return "deadline"
        if (self.policy.deadline_s is not None
                and home in self._first_wall
                and time.monotonic() - self._first_wall[home]
                >= self.policy.deadline_s):
            return "deadline"
        return None

    def due(self, home: Home) -> bool:
        """Whether ``home`` should flush now under the policy."""
        return self.due_reason(home) is not None

    def due_homes(self) -> List[Home]:
        """Homes whose pending work should flush now."""
        return [h for h in self._pending if self.due(h)]

    def fill(self, home: Home) -> int:
        """Σ block-union widths over the home's pending per-table
        streams — the tile-DMA count a flush-now would run."""
        return sum(tr.fill for tr in self._trackers[home].values())

    def homes_with_pending(self) -> List[Home]:
        """Homes holding at least one undelivered query."""
        return [h for h, q in self._pending.items() if q]

    def pending_total(self) -> int:
        """Queries buffered across every home (0 = quiesced)."""
        return sum(len(q) for q in self._pending.values())

    # --------------------------------------------------------------- take --

    def take(self, home: Home) -> Tuple[List[Tuple[str, int, list]], List[int] | None]:
        """Pops a home's pending batch and its flush participants.

        Returns ``(entries, participants)``: per-shard homes flush with
        ``participants=[home]`` (no cross-shard combine); an owner-set
        home flushes with exactly its frozen set; the pool flushes over
        the union of its queries' owner shards.  ``None`` (the full
        stack) is returned only when the set covers the mesh.
        """
        entries = self._pending[home]
        self._pending[home] = []
        self._trackers[home] = {}
        self._first_tick.pop(home, None)
        self._first_wall.pop(home, None)
        if home == POOL:
            owners = sorted(self._pool_owners)
            self._pool_owners = set()
            if not owners or len(owners) == self.num_shards:
                return entries, None
            return entries, owners
        if isinstance(home, tuple):
            if len(home) == self.num_shards:
                return entries, None
            return entries, list(home)
        return entries, [home]

    def state(self) -> Dict[str, object]:
        """Pending/fill snapshot for :meth:`ShardedEmbeddingServer.report`.

        Safe to call from a monitoring thread while the thread driver
        routes traffic: the dict views are materialized with C-level
        (GIL-atomic) ``list()`` copies before iteration, so a
        concurrently-created owner-set home can never raise
        ``dictionary changed size during iteration`` — the snapshot is
        merely allowed to be one push stale.
        """
        pending_items = list(self._pending.items())
        union_fill = {}
        pending_by_producer: Dict[str, int] = {}
        for h, q in pending_items:
            if q:
                trackers = list(self._trackers.get(h, {}).values())
                union_fill[str(h)] = sum(tr.fill for tr in trackers)
                for _t, seq, _q in list(q):
                    label = str(self._seq_decode(seq)[0])
                    pending_by_producer[label] = (
                        pending_by_producer.get(label, 0) + 1
                    )
        return {
            "pending": {str(h): len(q) for h, q in pending_items if q},
            "union_fill": union_fill,
            "tick": self._tick,
            "requeues": self.requeues,
            "quarantined": self.quarantined,
            "pending_by_producer": pending_by_producer,
            "pushed_by_producer": dict(self.pushed_by_producer),
        }
