"""Tiered host↔device embedding storage (DESIGN.md §9).

The port of ``repro.serve.tiers``, host NumPy.  Real DLRM tables run
10–100x larger than the device holds.  A tiered server makes the stacked
shard images a **hot tier**: a fixed per-shard ``capacity_tiles`` budget
caches the hottest groups of the host-resident fused master image, and
everything else is **cold** — served exactly by a host gather+sum over
the master image and eligible to page in when the drift tracker's
decayed loads say it warmed up.

  * :class:`TierConfig` — the knobs (budget as tiles or as a fraction of
    the uncapped image, hysteresis, host-queue batching).
  * :class:`ResidencyIndex` — the submit-time answer to "does this query
    touch any cold group?", re-snapshotted at each patch barrier only.
  * :class:`HostFetchQueue` — the deadline-batched queue cold queries
    wait in, with the device path's batch/deadline triggers.
  * :func:`gather_cold_rows` / :func:`sum_cold_rows` — the cold tier's
    compute: each query's distinct rows read from the master image and
    summed in float32 by the reference's reduction.

Invariants (pinned by ``tests/test_torch_tiers.py`` against the
reference): a compiled batch never references a cold tile; a
capacity-bounded server is bit-identical to the uncapped one on
integer-valued tables; paging happens only at flush barriers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.dist.replan import PagingPolicy
from repro_torch.dist.shard_plan import ShardPlan


@dataclasses.dataclass
class TierConfig:
    """Hot-tier knobs for :class:`~repro_torch.serve.sharded.ShardedEmbeddingServer`.

    Exactly one of ``capacity_tiles`` / ``capacity_frac`` must be set.

    Attributes:
      capacity_tiles: absolute per-shard hot-tier budget, in tiles.
      capacity_frac: budget as a fraction of the per-shard image depth
        an *uncapped* plan of the same tables would need (the launcher's
        ``--capacity-frac 0.25`` = "the device holds a quarter").
      hysteresis: load ratio a cold group must beat over its eviction
        victim to swap in (>= 1; see
        :class:`~repro_torch.dist.replan.PagingPolicy`).
      max_fetch_tiles: cap on tiles paged in per patch barrier (None =
        unbounded).
      min_fetch_load: decayed-load floor below which a cold group never
        pages in (0.0 = any observed traffic qualifies).
      host_batch: cold queries buffered before the host path serves
        them as one batch (None: the server's ``batch_size``).
      host_deadline: max submissions (to the whole server) a queued
        cold query waits before a forced host flush (None: 4x
        ``host_batch``).
    """

    capacity_tiles: int | None = None
    capacity_frac: float | None = None
    hysteresis: float = 1.5
    max_fetch_tiles: int | None = None
    min_fetch_load: float = 0.0
    host_batch: int | None = None
    host_deadline: int | None = None

    def __post_init__(self):
        if (self.capacity_tiles is None) == (self.capacity_frac is None):
            raise ValueError(
                "set exactly one of capacity_tiles / capacity_frac"
            )
        if self.capacity_frac is not None and not (
            0.0 < self.capacity_frac <= 1.0
        ):
            raise ValueError("capacity_frac must be in (0, 1]")
        if self.hysteresis < 1.0:
            raise ValueError(
                "hysteresis < 1 invites paging thrash (an evicted group "
                "could immediately displace its displacer)"
            )

    def resolve_capacity(self, uncapped_depth: int) -> int:
        """Budget in tiles, given the uncapped plan's per-shard depth."""
        if self.capacity_tiles is not None:
            return int(self.capacity_tiles)
        return max(1, int(np.floor(self.capacity_frac * uncapped_depth)))

    def paging_policy(self, capacity_tiles: int) -> PagingPolicy:
        """Resolved per-plan paging policy at a concrete capacity."""
        return PagingPolicy(
            capacity_tiles=int(capacity_tiles),
            hysteresis=float(self.hysteresis),
            max_fetch_tiles=self.max_fetch_tiles,
            min_fetch_load=float(self.min_fetch_load),
        )


class ResidencyIndex:
    """Submit-time row → hot/cold routing for a capacity-bounded plan.

    Holds the per-table ``row → fused group`` map (frozen: the grouping
    never changes at serve time) and a snapshot of the plan's resident
    mask, refreshed at each patch barrier via :meth:`refresh` — never
    mid-pipeline, so every query routed hot was routed against the
    residency its flush runs under.
    """

    def __init__(
        self, plan: ShardPlan, fused_group_of_row: Dict[str, np.ndarray]
    ):
        self._fused_group_of_row = {
            name: np.asarray(g, dtype=np.int64)
            for name, g in fused_group_of_row.items()
        }
        self._resident = plan.resident_group
        self.num_groups = plan.num_groups

    def refresh(self, plan: ShardPlan) -> None:
        """Re-snapshots residency after a plan patch (barrier only)."""
        self._resident = plan.resident_group

    @property
    def any_cold(self) -> bool:
        """True when at least one group lives outside the hot tier."""
        return not bool(self._resident.all())

    def fused_groups(self, table: str, rows: np.ndarray) -> np.ndarray:
        """Fused group id of each of ``table``'s ``rows``."""
        return self._fused_group_of_row[table][rows]

    def groups_of(self, table: str, query: np.ndarray) -> np.ndarray:
        """Distinct fused group ids a query's rows touch."""
        rows = np.asarray(query, dtype=np.int64)
        if rows.size == 0:
            return rows
        return np.unique(self._fused_group_of_row[table][rows])

    def is_resident(self, table: str, query: np.ndarray) -> bool:
        """True iff every row of the query lives in the hot tier."""
        if not self.any_cold:
            return True
        groups = self.groups_of(table, query)
        return bool(self._resident[groups].all())

    def host_group_loads(
        self, entries: List[Tuple[str, int, np.ndarray]]
    ) -> np.ndarray:
        """Per-fused-group active-row counts of a host-path batch.

        The host-side twin of :func:`repro_torch.core.reduction.
        fused_group_loads`: cold queries never compile, but their loads
        must feed the drift tracker or a cold group could never warm up
        and page in.  A query touching *k* distinct rows of a group
        counts *k*.
        """
        loads = np.zeros(self.num_groups, dtype=np.float64)
        for table, _seq, query in entries:
            rows = np.unique(np.asarray(query, dtype=np.int64))
            if rows.size:
                np.add.at(
                    loads, self._fused_group_of_row[table][rows], 1.0
                )
        return loads


class HostFetchQueue:
    """Deadline-batched buffer for cold-routed queries.

    A host flush is due when ``batch`` entries are buffered OR the
    oldest entry has waited ``deadline`` submissions.  Ticks are the
    server's submission counter (every submit, hot or cold, advances
    time — so a trickle of cold queries in a hot stream still meets its
    deadline).
    """

    def __init__(self, batch: int, deadline: int):
        self.batch = max(1, int(batch))
        self.deadline = max(1, int(deadline))
        self._entries: List[Tuple[str, int, np.ndarray]] = []
        self._first_tick: int | None = None

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, table: str, seq: int, query: np.ndarray, tick: int) -> None:
        """Buffers one cold-routed query for the host gather."""
        if self._first_tick is None:
            self._first_tick = int(tick)
        self._entries.append((table, int(seq), query))

    def due(self, tick: int) -> str | None:
        """``"batch"`` / ``"deadline"`` when a flush is due, else None."""
        if not self._entries:
            return None
        if len(self._entries) >= self.batch:
            return "batch"
        if int(tick) - self._first_tick >= self.deadline:
            return "deadline"
        return None

    def take(self) -> List[Tuple[str, int, np.ndarray]]:
        """Drains and returns every buffered entry (resets the deadline)."""
        out = self._entries
        self._entries = []
        self._first_tick = None
        return out

    def state(self) -> dict:
        """Queue depth + policy snapshot for reports."""
        return {"pending": len(self._entries),
                "first_tick": self._first_tick,
                "batch": self.batch, "deadline": self.deadline}


def gather_cold_rows(
    fused: np.ndarray, tiles: np.ndarray, slots: np.ndarray
) -> np.ndarray:
    """The master image's rows ``fused[tiles[i], slots[i]]``, ``(n, dim)``."""
    return fused[tiles, slots]


def sum_cold_rows(rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Per-query sums of consecutive runs of ``rows``.

    Query *i* owns the next ``lengths[i]`` rows; its sum is NumPy's sum
    over axis 0 of its float32 rows — the reduction the reference's host
    path applies to ``table[ids]``, so the bits agree on any table, not
    only on integer-valued ones.  An empty query sums to zeros.  Returns
    ``(len(lengths), dim)`` float32.
    """
    rows = rows.astype(np.float32, copy=False)
    out = np.zeros((len(lengths), rows.shape[1]), dtype=np.float32)
    start = 0
    for i, n in enumerate(np.asarray(lengths).tolist()):
        if n:
            out[i] = rows[start:start + n].sum(axis=0)
        start += n
    return out
