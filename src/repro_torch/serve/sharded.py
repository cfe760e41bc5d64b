"""Sharded multi-table embedding serving driver.

The port of ``repro.serve.sharded`` (DESIGN.md §4, §7, §8, §10).  Glues
the offline pipeline to the sharded online path for a *set* of DLRM
embedding tables:

  per table: history → co-occurrence → grouping (Alg. 1) → Eq.-1
  log-scaled replication → layout, then one :class:`~repro_torch.dist.
  shard_plan.ShardPlan` over the fused tile space and one stacked shard
  image, allocated once on the device.

A flush compiles each table's batch on the host (block-granular replica
choice), rebases it into the fused tile space, block-compiles it per
shard, and reduces it with :func:`repro_torch.kernels.sharded.
crossbar_reduce_tables` — the CUDA crossbar kernel once per shard and
combine chunk, combined in float32.

**Flush policies.**  Under ``"global"`` requests accumulate in one
buffer and flush synchronously at ``batch_size``.  Under
``"per-shard"`` / ``"deadline"`` / ``"owner-set"`` the loop becomes a
pipelined engine: queries route to homes
(:class:`~repro_torch.serve.scheduler.FlushScheduler`), homes flush
independently, a subset flush compiles with ``participants=`` exactly
the home's shards, and each dispatch is non-blocking — the host
compiles flush *n+1* while flush *n* runs on the card.  Each dispatched
flush records a ``torch.cuda.Event`` on the server's stream after its
last kernel; readiness is ``event.query()`` and result hand-off waits
on ``event.synchronize()`` (bounded in-flight queue / :meth:`drain`).
Every dispatch, and the thread driver's whole loop, runs on the one
stream the server captured at construction.  Retired rows stay on the
device until :meth:`drain` merges them.

**Thread driver** (``threaded=True``): the dispatch/retire loop moves
to a driver thread; ``submit()`` validates, stamps a sequence id and
enqueues onto a bounded hand-off queue.  **Multi-producer front door**:
each ``producer=`` owns a per-table sequence space
(:mod:`repro_torch.serve.producers`) and a full drain merges streams in
the deterministic ``(local_seq, producer_id)`` order.  **Self-healing**
(``retry=``): a failed dispatch retries with backoff, bisects down to a
single offender and quarantines it (:class:`~repro_torch.serve.faults.
ErrorLedger`); a kernel that cannot be built or launched
(:class:`~repro_torch.kernels._build.KernelError`) is re-raised instead.
A flush past the watchdog degrades to a host gather+sum over the logical
tables on a CPU server; on the card its batch goes back to its home and
:class:`~repro_torch.serve.faults.FlushTimeout` raises, since work never
moves from the card to the host.

**Online replanning** (``replan=``, DESIGN.md §6): each flush also feeds
its compiled batch's per-group loads — read off the CPU compile, so the
card is never waited for — to a :class:`~repro_torch.serve.drift.
DriftTracker`, between the kernels' dispatch and the wait for their
event.  When the decayed observation drifts past the configured
total-variation threshold, the server stages an incremental
:class:`~repro_torch.dist.replan.PlanPatch` and applies it at the next
flush (``"global"``) or pipeline barrier (async policies): the placement
arrays swap and only the patch's tiles are copied from the host master
image into the image stack (:func:`repro_torch.kernels.sharded.
patch_shard_images`, in place, on the server's stream).  Two deliberate
differences from the reference: only a server with ``replan=`` (which
``tiers=`` implies) keeps the host master image (the reference keeps it
on every server), and the patch writes the image in place.

**Tiered storage** (``tiers=``, DESIGN.md §9): the image stack becomes a
hot tier of fixed depth (a fraction of what an uncapped plan needs)
over the host master image.  Each submission is routed by residency
alone: a query touching a cold group waits in a deadline-batched host
queue, whose flush sums each query's distinct rows from the master
image in float32, copies them to the card in one pinned non-blocking
copy on the server's stream, and stores them beside the hot rows, so
:meth:`~ShardedEmbeddingServer.drain` merges both on the card.  The
host loads feed the drift tracker, and paging patches (``fetch_dma``)
swap groups in and out at barriers.

**Fault injection** (``faults=``, DESIGN.md §8): a seeded
:class:`~repro_torch.serve.faults.FaultPlan` fires at the compile,
dispatch, retire and patch-apply seams; a simulated hang keeps a flush
"not ready" for its duration.  A hung flush on the card is requeued and
raises :class:`~repro_torch.serve.faults.FlushTimeout`; only a CPU
server degrades it to the host.

**One process per shard** (``mesh=`` a :class:`~repro_torch.dist.mesh.
ShardMesh`, the counterpart of the reference's ``shard_map`` path).  The
reference is one controller: a single scheduler decides every flush, and
some decisions depend on time (the ``deadline_s`` trigger, the watchdog,
the thread driver), so they cannot be replayed in step on several ranks,
and ranks whose collectives disagree hang.  So rank 0 is the only
controller.  It runs the front door, the scheduler, the host compile,
drift, replanning and the tier host path exactly as the emulated server
does, and holds shard 0; every other rank runs :func:`serve_worker`,
which blocks on a control-plane header (``IMAGE``, ``FLUSH``, ``PATCH``
or ``STOP``), receives its own schedule, patch tiles or image shard as
CPU tensors, copies them to its device, runs its kernel and joins the
combine (:mod:`repro_torch.kernels.sharded`).  A patch's change of depth
rides its ``PATCH`` message: every rank resizes its own shard.

All control traffic is sent from the one thread that owns the engine
(the driver thread when ``threaded``; the constructor sends the image and
:meth:`~ShardedEmbeddingServer.close` sends ``STOP``), so the headers
reach every rank in one order.  The fault injector's seams fire on rank 0
before a flush's header is sent or after its result is received, never in
between, so an injected fault never leaves a worker inside a collective.
A failed collective or transfer raises :class:`~repro_torch.dist.mesh.
MeshError`, which, like :class:`~repro_torch.kernels._build.KernelError`,
is neither retried nor quarantined: the world is lost (the process
group's timeout is the backstop against a silent worker).  Each rank
holds only its own shard of the image.  Deliberate difference: after
:meth:`~ShardedEmbeddingServer.close` has stopped the workers, a flush
raises instead of serving work that was still pending at close.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.cooccurrence import build_cooccurrence
from repro_torch.core.grouping import correlation_aware_grouping
from repro_torch.core.mapping import build_layout, compile_activations
from repro_torch.core.reduction import (
    FusedActivations,
    ZeroedBitmaps,
    _to_device,
    shard_block_activations,
)
from repro_torch.core.replication import plan_replication
from repro_torch.dist.mesh import MeshError, ShardMesh
from repro_torch.dist.replan import (
    PlanPatch,
    apply_plan_patch,
    compute_plan_patch,
    rescale_load_to_plan,
)
from repro_torch.dist.shard_plan import ShardPlan, build_fused_image, plan_shards
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.sharded import (
    COMBINES,
    combine_bytes_per_batch,
    crossbar_reduce_sharded,
    crossbar_reduce_tables,
    dispatch_cache_stats,
    distribute_shard_images,
    patch_shard_images,
    result_bytes,
)
from repro_torch.serve.drift import DriftTracker, LoadObservationCache, ReplanConfig
from repro_torch.serve.faults import (
    ErrorLedger,
    FaultInjector,
    FlushTimeout,
    RetryPolicy,
    latency_percentiles,
)
from repro_torch.serve.producers import ProducerRegistry
from repro_torch.serve.scheduler import FlushPolicy, FlushScheduler
from repro_torch.serve.tiers import (
    HostFetchQueue,
    ResidencyIndex,
    TierConfig,
    gather_cold_rows,
    sum_cold_rows,
)


@dataclasses.dataclass
class _InFlight:
    """One dispatched-but-unretired flush (DESIGN.md §7.2)."""

    outs: List[torch.Tensor]               # per-table kernel outputs
    sbq: object                            # the flush's ShardedBlockedQueries
    served: List[str]                      # table names, outs order
    seqs: Dict[str, np.ndarray]            # per-table submission sequence ids
    t0: float                              # host compile start (perf_counter)
    n_queries: int
    host_acts: object = None               # FusedActivations (drift observation)
    # recorded on the server's stream after the flush's last kernel;
    # None (CPU tensors, a test stub) counts as complete
    event: Optional[object] = None
    # ---- healing metadata (DESIGN.md §8): the raw batch so a retire-
    # time fault can re-dispatch it and a watchdog timeout can degrade
    # it to the host path ----
    home: object = None
    entries: Optional[List[tuple]] = None  # raw (table, seq, query) triples
    participants: Optional[List[int]] = None
    t_dispatch: float = 0.0                # kernel dispatch (perf_counter)
    # injected hang: not ready until hang_s after dispatch (inf = never)
    hang_s: Optional[float] = None


#: bound of the driver-failure stash (first-in surfaces first; overflow
#: is counted, never silently dropped) — see _stash_driver_error
_MAX_STASHED_ERRORS = 8


@dataclasses.dataclass
class ShardedServeStats:
    """Accumulated per-flush accounting of the sharded datapath.

    Under an async flush policy ``wall_s`` is the sum of per-flush
    dispatch→retire latencies, which OVERLAP; the pipelining shows up as
    ``hidden_compile_s`` (host compile time that ran while an earlier
    flush was still running on the card) over ``host_compile_s``.
    Latency samples are kept raw (one float per flush / per submit / per
    async query) so :meth:`summary` can report percentiles.  The tier
    counters count a tiered server's hot/host routing, host flushes and
    paging (zero without ``tiers=``); ``load_obs_*`` count the drift
    observation's memo.
    """

    num_shards: int
    q_block: int
    policy: str = "global"
    batches: int = 0
    queries: int = 0
    blocks: int = 0
    grid_cells_per_shard: int = 0          # Σ over flushes of nb × max_tiles
    max_grid_cells_per_flush: int = 0
    max_shard_width: int = 0               # widest per-shard block union seen
    combine_bytes: int = 0
    wall_s: float = 0.0
    # ---- async flush scheduling (DESIGN.md §7) ----
    shard_flushes: Dict[object, int] = dataclasses.field(default_factory=dict)
    participant_sizes: Dict[int, int] = dataclasses.field(default_factory=dict)
    barrier_flushes: int = 0               # pipeline drains (patch/explicit)
    deadline_flushes: int = 0              # flushes forced by query age
    host_compile_s: float = 0.0            # Σ per-flush host compile time
    hidden_compile_s: float = 0.0          # … of which overlapped device exec
    in_flight_peak: int = 0                # deepest dispatch queue seen
    flush_wall: List[float] = dataclasses.field(default_factory=list)
    submit_wall: List[float] = dataclasses.field(default_factory=list)
    # submit-stamp → result-retired, one sample per async query
    # (quarantined queries never complete, so they never sample)
    e2e_wall: List[float] = dataclasses.field(default_factory=list)
    # ---- online replanning (DESIGN.md §6) ----
    replans: int = 0                       # patches applied (moves > 0)
    rebases: int = 0                       # no-op patches (load reanchor only)
    patched_tiles: int = 0                 # Σ tiles copied by applied patches
    promoted_groups: int = 0
    demoted_groups: int = 0
    # ---- tiered host/device storage (DESIGN.md §9) ----
    hot_queries: int = 0
    host_queries: int = 0
    host_flushes: int = 0
    host_deadline_flushes: int = 0
    sync_cold_batches: int = 0
    fetched_tiles: int = 0
    evicted_tiles: int = 0
    paging_bytes: int = 0
    load_obs_hits: int = 0                 # drift-observation memo hits
    load_obs_misses: int = 0
    # ---- mesh (one process per shard) ----
    # point-to-point result sends to rank 0, outside combine_bytes; read
    # by report()["mesh"], not summary() (the reference's keys)
    result_bytes: int = 0
    # ---- failure/recovery accounting (DESIGN.md §8) ----
    ledger: ErrorLedger = dataclasses.field(default_factory=ErrorLedger)

    def record(self, sbq, dim: int, wall_s: float, queries: int) -> None:
        """Accounts one served batch: grid cells, widths, combine
        traffic (scaled to the flush's participant set), wall time."""
        cells = sbq.grid_cells_per_shard()
        self.batches += 1
        self.queries += queries
        self.blocks += sbq.num_blocks
        self.grid_cells_per_shard += cells
        self.max_grid_cells_per_flush = max(self.max_grid_cells_per_flush, cells)
        self.max_shard_width = max(
            self.max_shard_width, int(np.max(sbq.shard_widths, initial=0))
        )
        # the reference's ring rule: a single participant combines
        # nothing; a subset that divides the shard count rings only its
        # participants, any other subset the full axis
        p = sbq.num_shards
        ring = p if (p == 1 or self.num_shards % p == 0) else self.num_shards
        self.combine_bytes += combine_bytes_per_batch(
            sbq.num_blocks * sbq.q_block, dim, ring
        )
        self.participant_sizes[p] = self.participant_sizes.get(p, 0) + 1
        self.wall_s += wall_s
        self.flush_wall.append(wall_s)

    def record_flush_home(self, home) -> None:
        """Counts one dispatched flush against its home (an int shard,
        the POOL sentinel -1, or an owner-set tuple)."""
        self.shard_flushes[home] = self.shard_flushes.get(home, 0) + 1

    def record_submit(self, seconds: float) -> None:
        """Accounts one submit() call's host latency."""
        self.submit_wall.append(seconds)

    def record_compile(self, seconds: float, *, hidden: bool) -> None:
        """Accounts one flush's host compile; ``hidden`` when at least
        one earlier flush was still running on the card as it ended."""
        self.host_compile_s += seconds
        if hidden:
            self.hidden_compile_s += seconds

    @property
    def overlap_fraction(self) -> float:
        """Fraction of host compile time hidden behind device execution."""
        return (self.hidden_compile_s / self.host_compile_s
                if self.host_compile_s > 0 else 0.0)

    def record_patch(self, patch: PlanPatch, tile_bytes: int = 0) -> None:
        """Accounts one applied plan patch (replan vs rebase, moved
        tiles, promotions/demotions, paging traffic)."""
        fetched = len(getattr(patch, "fetch_dma", ()) or ())
        self.fetched_tiles += fetched
        self.evicted_tiles += int(getattr(patch, "evicted_tiles", 0) or 0)
        self.paging_bytes += fetched * int(tile_bytes)
        if patch.is_noop():
            self.rebases += 1
            return
        self.replans += 1
        self.patched_tiles += patch.num_moved_tiles + patch.num_relocated_tiles
        self.promoted_groups += len(patch.promoted)
        self.demoted_groups += len(patch.demoted)

    def summary(self) -> Dict[str, object]:
        """Flat metrics dict for reports (counters, latency percentiles,
        tier and failure accounting) — the reference's keys."""
        return {
            "num_shards": self.num_shards,
            "q_block": self.q_block,
            "flush_policy": self.policy,
            "batches": self.batches,
            "queries": self.queries,
            "blocks": self.blocks,
            "grid_cells_per_shard": self.grid_cells_per_shard,
            "max_grid_cells_per_flush": self.max_grid_cells_per_flush,
            "max_shard_width": self.max_shard_width,
            "combine_bytes": self.combine_bytes,
            "wall_s": self.wall_s,
            "shard_flushes": {
                str(k): v for k, v in sorted(
                    self.shard_flushes.items(), key=lambda kv: str(kv[0])
                )
            },
            "participant_sizes": {
                str(k): v for k, v in sorted(self.participant_sizes.items())
            },
            "flush_latency_s": latency_percentiles(self.flush_wall),
            "submit_latency_s": latency_percentiles(self.submit_wall),
            "e2e_latency_s": latency_percentiles(self.e2e_wall),
            "barrier_flushes": self.barrier_flushes,
            "deadline_flushes": self.deadline_flushes,
            "host_compile_s": self.host_compile_s,
            "hidden_compile_s": self.hidden_compile_s,
            "overlap_fraction": self.overlap_fraction,
            "in_flight_peak": self.in_flight_peak,
            "replans": self.replans,
            "rebases": self.rebases,
            "patched_tiles": self.patched_tiles,
            "promoted_groups": self.promoted_groups,
            "demoted_groups": self.demoted_groups,
            "tiers": self.tier_summary(),
            "faults": self.ledger.summary(),
        }

    def tier_summary(self) -> Dict[str, object]:
        """Hot-tier metrics under the reference's keys (an untiered
        server reads as all-resident)."""
        routed = self.hot_queries + self.host_queries
        return {
            "hot_queries": self.hot_queries,
            "host_queries": self.host_queries,
            "hot_tier_hit_rate": (
                self.hot_queries / routed if routed else 1.0
            ),
            "host_path_fraction": (
                self.host_queries / routed if routed else 0.0
            ),
            "host_flushes": self.host_flushes,
            "host_deadline_flushes": self.host_deadline_flushes,
            "sync_cold_batches": self.sync_cold_batches,
            "fetched_tiles": self.fetched_tiles,
            "evicted_tiles": self.evicted_tiles,
            "paged_tiles": self.fetched_tiles + self.evicted_tiles,
            "paging_bytes": self.paging_bytes,
            "load_obs_hits": self.load_obs_hits,
            "load_obs_misses": self.load_obs_misses,
        }


def _host_table(t: torch.Tensor) -> np.ndarray:
    """Host copy for the plan/image build and the CPU degrade path (bf16
    widens to float32, which the permutation-only image build carries
    exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class ShardedEmbeddingServer:
    """Multi-table embedding-reduction server.

    Args:
      tables: ``{name: (rows, dim) tensor}`` logical tables
        (:func:`repro_torch.convert.tables_from_numpy` makes them from the
        JAX side's arrays).  The image keeps their dtype.  A CPU server
        under an async policy keeps a host copy of each (float32 for
        bf16) for the watchdog's degrade path; a CUDA server keeps none.
        With ``replan=`` (or ``tiers=``) the server also keeps the fused
        host master image (float32 for bf16) its patches copy tiles from
        and its cold tier reads rows from.
      histories: ``{name: ragged lookup history}`` driving the offline
        pipeline (grouping + Eq.-1 replication) per table.
      num_shards: shards to plan for; emulated on one device, or one
        process each under ``mesh=``.
      q_block: queries per kernel block.
      group_size: crossbar height (tile rows).
      batch_size: auto-flush threshold for :meth:`submit`.
      batch_size_for_eq1: Eq. 1's ``batch``; defaults to ``batch_size``.
        Online replanning re-evaluates Eq. 1 at this batch size unless
        ``replan.eq1_batch`` overrides it.
      combine_chunks: block-axis chunks (one kernel launch each per shard).
      dynamic_switch: enable the paper's §III-D READ/MAC switch.
      device: where the shard images live and the kernels run.  On a
        CUDA device every dispatch runs on the stream current at
        construction.
      flush_policy: ``"global"`` (synchronous, default) or an async kind
        — ``"per-shard"`` / ``"deadline"`` / ``"owner-set"`` — or a full
        :class:`~repro_torch.serve.scheduler.FlushPolicy`.  Results of an
        async policy are collected with :meth:`drain` (or :meth:`flush`,
        a barrier in async mode).  DESIGN.md §7.
      union_budget / flush_deadline / flush_deadline_s / owner_set_max /
        max_in_flight: async policy knobs (see :class:`~repro_torch.
        serve.scheduler.FlushPolicy`).
      threaded: run the async engine on a driver thread; :meth:`close`
        (or the context manager) stops it.  Requires an async policy.
      retry: the self-healing policy (:class:`~repro_torch.serve.faults.
        RetryPolicy`; ``None`` = defaults, healing on, watchdog off).
      replan: optional :class:`~repro_torch.serve.drift.ReplanConfig`
        enabling drift-triggered incremental replanning (DESIGN.md §6).
      tiers: optional :class:`~repro_torch.serve.tiers.TierConfig`
        (DESIGN.md §9): the image stack becomes a hot tier of fixed
        depth, cold queries take the host path over the master image,
        and drift pages groups in and out at barriers.  Implies a
        default ``ReplanConfig`` when ``replan`` is not given;
        ``replan.slack_tiles`` / ``shrink_streak`` are ignored (the
        depth IS the capacity).
      faults: optional :class:`~repro_torch.serve.faults.FaultPlan` or
        :class:`~repro_torch.serve.faults.FaultInjector` (DESIGN.md §8)
        consulted at the compile, dispatch, retire and patch seams.
      mesh: a :class:`~repro_torch.dist.mesh.ShardMesh` of
        ``num_shards`` ranks: the server runs on rank 0 and holds shard
        0, every other rank runs :func:`serve_worker` (see the module
        docstring); ``device`` must be of the mesh device's kind.
        ``None`` emulates the shards on one device.
      axis_name: the mesh axis the image shards over (``"model"``).
      combine: the mesh's cross-shard collective, ``"psum_scatter"``
        (reduce-scatter over the embedding dim + all-gather) or
        ``"psum"``; the emulation ignores it.
    """

    def __init__(
        self,
        tables: Dict[str, torch.Tensor],
        histories: Dict[str, Sequence[Sequence[int]]],
        *,
        num_shards: int = 1,
        q_block: int = 8,
        group_size: int = 64,
        batch_size: int = 256,
        batch_size_for_eq1: int | None = None,
        combine_chunks: int = 2,
        dynamic_switch: bool = True,
        device="cuda",
        mesh: ShardMesh | None = None,
        axis_name: str = "model",
        combine: str = "psum_scatter",
        flush_policy: str | FlushPolicy = "global",
        union_budget: int | None = None,
        flush_deadline: int | None = None,
        flush_deadline_s: float | None = None,
        owner_set_max: int | None = None,
        max_in_flight: int = 2,
        threaded: bool = False,
        retry: RetryPolicy | None = None,
        replan: ReplanConfig | None = None,
        tiers: TierConfig | None = None,
        faults=None,
    ):
        if mesh is not None:
            if not isinstance(mesh, ShardMesh):
                raise TypeError(
                    "mesh= takes a repro_torch.dist.mesh.ShardMesh (one process "
                    f"per shard), got {type(mesh).__name__}"
                )
            if mesh.rank != 0:
                raise ValueError(
                    f"the server runs on rank 0; rank {mesh.rank} runs serve_worker()"
                )
            if mesh.size != num_shards:
                raise ValueError(
                    f"mesh of {mesh.size} ranks for {num_shards} shards"
                )
            if torch.device(device).type != mesh.device.type:
                raise ValueError(
                    f"device {device!r} on a mesh whose device is {mesh.device}"
                )
            device = mesh.device
        if combine not in COMBINES:
            raise ValueError(f"unknown combine {combine!r}")
        if set(tables) != set(histories):
            raise ValueError("tables and histories must cover the same names")
        if not tables:
            raise ValueError("need at least one table")
        knobs_set = (union_budget is not None or flush_deadline is not None
                     or flush_deadline_s is not None
                     or owner_set_max is not None or max_in_flight != 2
                     or threaded)
        if isinstance(flush_policy, str):
            if knobs_set:
                flush_policy = FlushPolicy(
                    kind=flush_policy, union_budget=union_budget,
                    deadline=flush_deadline, deadline_s=flush_deadline_s,
                    owner_set_max=owner_set_max,
                    max_in_flight=max_in_flight, threaded=threaded,
                )
        elif knobs_set:
            raise ValueError(
                "pass the flush knobs inside the FlushPolicy instance OR "
                "as keyword args with a policy-kind string, not both"
            )
        self.policy = FlushPolicy.parse(flush_policy, batch_size=batch_size)
        self.retry = RetryPolicy.parse(retry)
        self.names = sorted(tables)
        self.num_shards = num_shards
        self.q_block = q_block
        self.batch_size = batch_size
        self.combine_chunks = combine_chunks
        self.dynamic_switch = dynamic_switch
        self.mesh = mesh
        self.axis_name = axis_name
        self.combine = combine
        #: the mesh workers: "live", "stopped" (close() sent STOP) or
        #: "lost" (a mesh operation failed)
        self._mesh_state = "live"
        self.device = torch.device(device)
        #: every dispatch and the driver thread's loop run on this stream
        self._stream = (
            torch.cuda.current_stream(self.device)
            if self.device.type == "cuda" else None
        )
        #: the schedules' bitmaps, kept zeroed between batches on that stream
        self._bitmaps = ZeroedBitmaps()

        dtypes = {tables[n].dtype for n in self.names}
        if len(dtypes) != 1:
            raise ValueError("fused serving requires a uniform table dtype")
        self.dtype = dtypes.pop()
        eq1_batch = batch_size_for_eq1 or batch_size
        # host copies of the logical tables: the plan/image build reads
        # them; an async CPU server keeps them for the watchdog's degraded
        # flush (reference gather+sum), a CUDA server frees them here
        host = {n: _host_table(tables[n]) for n in self.names}
        self.layouts, plans, gfreqs = [], [], []
        dims = set()
        for name in self.names:
            table = host[name]
            with trace.span("plan.cooccurrence"):
                graph = build_cooccurrence(histories[name], table.shape[0])
            with trace.span("plan.grouping"):
                grouping = correlation_aware_grouping(graph, group_size)
            with trace.span("plan.replication"):
                plan = plan_replication(grouping, graph.freq, eq1_batch)
                self.layouts.append(build_layout(grouping, plan, table.shape[1]))
            plans.append(plan)
            gfreqs.append(grouping.group_freq(graph.freq))
            dims.add(table.shape[1])
        if len(dims) != 1:
            raise ValueError("fused serving requires a uniform embedding dim")
        self.dim = dims.pop()
        self.tiers = tiers
        if tiers is not None and replan is None:
            # paging rides the drift tracker
            replan = ReplanConfig()
        self._capacity_tiles: Optional[int] = None
        with trace.span("plan.placement"):
            if tiers is not None:
                # the budget is a fraction of what an UNCAPPED plan of the
                # same tables needs per shard
                uncapped = plan_shards(
                    self.layouts, plans, num_shards, names=self.names,
                    group_freqs=gfreqs,
                )
                self._capacity_tiles = tiers.resolve_capacity(uncapped.max_local_tiles)
                del uncapped
            self.plan: ShardPlan = plan_shards(
                self.layouts, plans, num_shards, names=self.names, group_freqs=gfreqs,
                capacity_tiles=self._capacity_tiles,
            )
        with trace.span("plan.image"):
            fused = build_fused_image(self.layouts, [host[n] for n in self.names])
            images = self.plan.build_shard_images(fused)
            if self._capacity_tiles is not None:
                # the hot tier is FIXED at its budget: every free slot is
                # fetchable from the start
                extra = self._capacity_tiles - images.shape[1]
                if extra > 0:
                    pad = np.zeros(
                        (num_shards, extra) + images.shape[2:], dtype=images.dtype
                    )
                    images = np.concatenate([images, pad], axis=1)
            elif replan is not None and replan.slack_tiles > 0:
                # zero-tile headroom so early promotions fill slack instead
                # of growing (reallocating) the image stack on the device
                pad = np.zeros(
                    (num_shards, replan.slack_tiles) + images.shape[2:],
                    dtype=images.dtype,
                )
                images = np.concatenate([images, pad], axis=1)
            #: (num_shards, capacity, tile_rows, dim) on the device, or this
            #: rank's shard (1, ...) under a mesh; replaced only when a plan
            #: patch grows or shrinks its depth
            if mesh is None:
                self.shard_images = torch.from_numpy(images).to(
                    device=self.device, dtype=self.dtype
                )
            else:
                # each rank receives its shard once, here, outside any timed
                # window; rank 0 keeps shard 0
                with self._mesh_ops():
                    self._send_header(_OP_IMAGE)
                    self.shard_images = distribute_shard_images(images, mesh, self.dtype)
        del images
        # ---- online replanning state (DESIGN.md §6) ----
        self.replan_cfg = replan
        self._eq1_batch = (
            replan.eq1_batch if replan and replan.eq1_batch else eq1_batch
        )
        # the host master image, the source of every patch's tiles and of
        # the cold tier's rows: kept only with replan= (tiers= implies
        # it; the reference keeps it on every server)
        self._fused: Optional[np.ndarray] = fused if replan is not None else None
        del fused
        #: host→device bytes of one fused tile, in the image dtype
        self._tile_bytes = (
            self.layouts[0].tile_rows * self.dim * self.shard_images.element_size()
        )
        self._tile_group = np.repeat(
            np.arange(self.plan.num_groups, dtype=np.int64),
            self.plan.group_copies,
        )
        # per-table training-time load mass: Eq. 1 is evaluated at this
        # magnitude at replan time (see rescale_load_to_plan)
        self._segments = [
            (seg.group_offset, seg.group_offset + seg.num_groups)
            for seg in self.plan.tables
        ]
        self._seg_load_totals = [
            float(self.plan.group_load[a:b].sum()) for a, b in self._segments
        ]
        self.tracker: Optional[DriftTracker] = (
            DriftTracker(self.plan.group_load, half_life=replan.half_life,
                         min_queries=replan.min_queries)
            if replan is not None else None
        )
        self._staged: Optional[PlanPatch] = None
        self._demote_streak = 0
        # per-flush drift-observation memo (content-keyed)
        self._load_obs: Optional[LoadObservationCache] = (
            LoadObservationCache() if replan is not None else None
        )
        # patch-apply failures in a row: _apply_staged_patch counts here
        # and drops the patch past retry.patch_retries
        self._patch_fail_streak = 0
        # ---- tiered storage state (DESIGN.md §9); None when untiered --
        self._residency: Optional[ResidencyIndex] = None
        self._host_queue: Optional[HostFetchQueue] = None
        self._tick = 0
        if tiers is not None:
            name_to_layout = dict(zip(self.names, self.layouts))
            self._residency = ResidencyIndex(self.plan, {
                seg.name: np.asarray(
                    name_to_layout[seg.name].group_of, dtype=np.int64
                ) + seg.group_offset
                for seg in self.plan.tables
            })
            hb = tiers.host_batch or batch_size
            self._host_queue = HostFetchQueue(hb, tiers.host_deadline or 4 * hb)
            # a cold row's home in the master image: replica 0 of its
            # fused group (group_copies is frozen, so is this) at its slot
            self._group_tile0 = np.concatenate(
                [[0], np.cumsum(self.plan.group_copies)[:-1]]
            ).astype(np.int64)
            self._slot_of = {
                n: np.asarray(l.slot_of, dtype=np.int64)
                for n, l in zip(self.names, self.layouts)
            }
        self.stats = ShardedServeStats(
            num_shards=num_shards, q_block=q_block, policy=self.policy.kind
        )
        self._num_rows = {n: int(tables[n].shape[0]) for n in self.names}
        self._host_tables: Optional[Dict[str, np.ndarray]] = (
            host if self.device.type == "cpu" and self.policy.is_async else None
        )
        del host
        self._buffer: Dict[str, List[List[int]]] = {n: [] for n in self.names}
        self._buffered = 0
        # ---- async flush engine state (DESIGN.md §7); inert under the
        # synchronous "global" policy ----
        # per-producer sequence spaces (DESIGN.md §10): every stamped id
        # packs (local_seq, producer_id) into one int64
        self._registry = ProducerRegistry()
        self.scheduler: Optional[FlushScheduler] = (
            FlushScheduler(self.plan, self.layouts, self.names,
                           q_block, self.policy,
                           seq_decode=self._registry.decode)
            if self.policy.is_async else None
        )
        self._in_flight: collections.deque = collections.deque()
        # retired rows stay on the device: (seqs, rows tensor) chunks
        self._completed: Dict[str, List[Tuple[np.ndarray, torch.Tensor]]] = {
            n: [] for n in self.names
        }
        self._retry_rng = np.random.default_rng(self.retry.seed)
        self._injector = FaultInjector.parse(faults)
        if self._injector is not None:
            # poison keying speaks (table, producer, LOCAL seq): the
            # injector decodes the packed ids the engine hands it
            self._injector.bind_decoder(self._registry.decode)
        # ---- thread driver state (DESIGN.md §7.2); started lazily on
        # the first submit under a threaded policy ----
        self._handoff: Optional[queue.Queue] = None
        self._driver: Optional[threading.Thread] = None
        self._driver_stop = threading.Event()
        # driver failures stash into a BOUNDED deque: the first error is
        # surfaced first (with the count of others), overflow beyond the
        # bound is counted in the ledger
        self._driver_errors: collections.deque = collections.deque()
        self._suppressed_errors = 0
        # stamp lock: registration + seq stamp + closed check + driver
        # start are one atomic step
        # lock order (DESIGN.md §5): 3rd — after engine/results, before
        # the registry's lock
        self._stamp_lock = threading.Lock()
        # engine lock: serializes the global buffer and the INLINE async
        # engine under concurrent producers; the thread driver never
        # takes it (the hand-off queue is its serialization)
        # lock order (DESIGN.md §5): outermost — taken before any other
        self._engine_lock = threading.RLock()
        # results lock: _completed appends (retire) vs the drain-time
        # extract-and-swap
        # lock order (DESIGN.md §5): 2nd — after engine, before stamp
        self._results_lock = threading.Lock()
        self._closed = False
        #: synchronous requests served: the trace's request number
        self._requests = 0
        # submits past the stamp but not yet delivered — the seq-reset
        # guard and close()'s drain loop both key off this being zero
        self._pending_submits = 0
        # submit-stamp timestamps, popped when the row retires — the
        # e2e_latency_s samples (async paths only)
        self._e2e_t0: Dict[Tuple[str, int], float] = {}

    def _on_stream(self):
        """Makes the server's device and stream current (no-op on CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _record_event(self):
        """An event after the work queued so far on the server's stream
        (``None`` on CPU, where the work is already done)."""
        if self._stream is None:
            return None
        event = torch.cuda.Event()
        event.record(self._stream)
        return event

    # ------------------------------------------------------------ serving --

    def serve(
        self, queries_by_table: Dict[str, Sequence[Sequence[int]]]
    ) -> Dict[str, torch.Tensor]:
        """Serves one synchronous multi-table batch.

        Applies a staged plan patch (``"global"``), compiles each table's
        ragged queries on the host, rebases them into the fused tile
        space, block-compiles per shard and dispatches the sharded
        kernel; while the card runs it, the drift observation runs on the
        host (``replan=``), then the call waits for the kernel.  On an
        async server this is a barrier first: pending and in-flight work
        drains, and a staged patch applies, before the batch compiles.
        On a tiered server the queries that touch a cold group are split
        off against the post-patch residency and summed on the host from
        the master image; hot and cold rows are assembled on the card.

        Args:
          queries_by_table: ``{table name: ragged row-id queries}``;
            tables absent or mapped to an empty list are skipped.

        Returns:
          ``{table name: (batch, dim) reduction}`` on the server's device
          for every table that had at least one query.

        Raises:
          KeyError: a key names an unknown table.
        """
        self._requests += 1
        with trace.span("serve.request", self._requests):
            return self._serve(queries_by_table)

    def _serve(
        self, queries_by_table: Dict[str, Sequence[Sequence[int]]]
    ) -> Dict[str, torch.Tensor]:
        """:meth:`serve`'s request, inside its span."""
        t0 = time.perf_counter()
        unknown = set(queries_by_table) - set(self.names)
        if unknown:
            raise KeyError(f"unknown tables {sorted(unknown)!r}")
        served = [n for n in self.names if queries_by_table.get(n)]
        if not served:
            return {}
        # a synchronous serve is a barrier: async-pending queries flush
        # under the plan they were routed against and the pipeline drains
        # (the barrier applies any staged patch); in global mode nothing
        # is ever in flight and the staged patch applies here
        if self.scheduler is not None:
            self._barrier()
        else:
            self._apply_staged_patch()
        queries_of = {n: list(queries_by_table[n]) for n in served}
        # residency split (DESIGN.md §9), against the post-patch plan: a
        # compiled batch may never reference a cold tile
        cold_of: Dict[str, List[int]] = {}
        if self._residency is not None:
            for n in served:
                cold = [i for i, q in enumerate(queries_of[n])
                        if not self._residency.is_resident(
                            n, np.asarray(list(q), dtype=np.int64))]
                if cold:
                    cold_of[n] = cold
            cold_entries = [(n, i, queries_of[n][i])
                            for n in cold_of for i in cold_of[n]]
            if cold_entries:
                self.stats.host_queries += len(cold_entries)
                self.stats.sync_cold_batches += 1
                if self.tracker is not None:
                    # cold queries never compile; their loads must feed
                    # the tracker or a cold group can never warm up
                    self.tracker.observe(
                        self._residency.host_group_loads(cold_entries),
                        len(cold_entries),
                    )
            self.stats.hot_queries += sum(
                len(queries_of[n]) for n in served
            ) - len(cold_entries)
        hot_of = {}
        for n in served:
            cold = set(cold_of.get(n, ()))
            hot_of[n] = [q for i, q in enumerate(queries_of[n]) if i not in cold]
        served_dev = [n for n in served if hot_of[n]]
        n_hot = sum(len(hot_of[n]) for n in served_dev)
        outs, sbq, event = [], None, None
        if served_dev:
            with self._on_stream():
                with trace.span("serve.compile") as compiling:
                    tc = time.perf_counter()
                    host_acts, sbq, spans = self._compile_batch(
                        served_dev, {n: hot_of[n] for n in served_dev}
                    )
                    compile_s = time.perf_counter() - tc
                    compiling.record(compile_s)
                # a synchronous compile sits on the serving critical path
                self.stats.record_compile(compile_s, hidden=False)
                outs = self._reduce(sbq, spans)
                event = self._record_event()
            # the kernels are dispatched but not waited for: the drift
            # observation is host work on the sparse compile and overlaps them
            self._observe_and_stage(host_acts, n_hot)
        elif self.tracker is not None:
            # an all-cold batch still observed loads above: give the drift
            # statistic its chance to stage a paging patch
            self._maybe_stage()
        out = dict(zip(served_dev, outs))
        if cold_of:
            out.update(self._assemble(queries_of, cold_of, out))
        if event is not None:
            with trace.span("serve.wait"):
                event.synchronize()
        if sbq is not None:
            self.stats.record(sbq, self.dim, time.perf_counter() - t0, n_hot)
        return out

    def _assemble(self, queries_of, cold_of, hot_out) -> Dict[str, torch.Tensor]:
        """The sync path's tables that had cold queries: their host rows
        (one copy to the card) and hot rows placed by position on the
        card, in the server's dtype."""
        entries = [(n, i, queries_of[n][i]) for n in cold_of for i in cold_of[n]]
        cold_rows = self._cold_rows(entries)
        out, start = {}, 0
        with self._on_stream():
            for n, cold in cold_of.items():
                full = torch.empty(
                    (len(queries_of[n]), self.dim), dtype=self.dtype, device=self.device
                )
                full.index_copy_(0, _to_device(np.asarray(cold), self.device),
                                 cold_rows[start:start + len(cold)])
                start += len(cold)
                if n in hot_out:
                    hot = np.setdiff1d(np.arange(len(queries_of[n])), cold)
                    full.index_copy_(0, _to_device(hot, self.device), hot_out[n])
                out[n] = full
        return out

    def _cold_rows(self, entries) -> torch.Tensor:
        """The cold tier's compute: each ``(table, seq, query)`` entry's
        distinct rows read from the host master image, summed in float32
        and copied to the server's device in one pinned, non-blocking
        copy on its stream (rounded once to the server's dtype there).
        Returns ``(len(entries), dim)`` rows in entry order."""
        tiles, slots, lengths = [], [], []
        for table, _seq, query in entries:
            ids = np.unique(np.asarray(list(query), dtype=np.int64))
            tiles.append(self._group_tile0[self._residency.fused_groups(table, ids)])
            slots.append(self._slot_of[table][ids])
            lengths.append(ids.size)
        rows = gather_cold_rows(self._fused, np.concatenate(tiles), np.concatenate(slots))
        sums = sum_cold_rows(rows, np.asarray(lengths, dtype=np.int64))
        with self._on_stream():
            return _to_device(sums, self.device, self.dtype)

    def _compile_batch(self, served, queries_of, participants=None):
        """Fused host compile: each table's sparse activation set
        (block-granular replica choice) → the per-shard blocked schedule
        for ``participants`` (``None`` = every shard), built from the
        sparse sets with :func:`shard_block_activations`: the tile ids
        and the ones' flat indices cross to the device, and the ones are
        set there in the server's kept-zeroed bitmap buffer (kept on the
        CPU under a mesh, whose ranks each take their own schedule).  The
        bitmap is valid until the next compile.

        Returns ``(host_acts, sbq, spans)``: ``host_acts`` is the batch's
        :class:`FusedActivations` on the host, which the drift
        observation reads (``None`` on a server without a tracker).
        """
        tables = [self.names.index(name) for name in served]
        acts = []
        for i, name in zip(tables, served):
            with trace.span("compile.activations"):
                acts.append(compile_activations(
                    self.layouts[i], queries_of[name], replica_block=self.q_block,
                ))
        offsets = [self.plan.tables[i].tile_offset for i in tables]
        # only the drift observation reads the fused activations
        fused = FusedActivations.of(acts, offsets) if self.tracker is not None else None
        sbq, spans = shard_block_activations(
            acts, offsets, self.plan, self.q_block, participants=participants,
            device="cpu" if self.mesh is not None else self.device, dtype=self.dtype,
            fused=fused, bitmaps=self._bitmaps,
        )
        return fused, sbq, spans

    # ------------------------------------------------------------- mesh --

    def _reduce(self, sbq, spans) -> List[torch.Tensor]:
        """Dispatches one compiled batch's kernels and combine: in
        program when emulated, else across the mesh (:meth:`_reduce_mesh`).
        Credits the batch's slot counts to the trace, where it has them."""
        with trace.span("serve.dispatch"):
            if sbq.slot_counts is not None:
                slots, single, multi_ones = sbq.slot_counts
                trace.count("slots", slots)
                trace.count("read_slots", single if self.dynamic_switch else 0)
                # a slot holds at least one one, so a single-entry slot
                # holds exactly one; with the switch off it is summed too
                trace.count("mac_ones", multi_ones if self.dynamic_switch
                            else multi_ones + single)
            if self.mesh is None:
                return crossbar_reduce_tables(
                    self.shard_images, sbq, spans,
                    combine_chunks=self.combine_chunks,
                    dynamic_switch=self.dynamic_switch,
                )
            with self._mesh_ops():
                return self._reduce_mesh(sbq, spans)

    def _send_header(self, op: int, *values: int) -> None:
        """Broadcasts one control header to the workers (rank 0 only)."""
        if self._mesh_state != "live":
            raise MeshError(
                f"the mesh workers are {self._mesh_state}; this server "
                "dispatches nothing more"
            )
        header = [op, *values]
        header += [-1] * (_header_len(self.num_shards) - len(header))
        self.mesh.broadcast_header(header)

    @contextlib.contextmanager
    def _mesh_ops(self):
        """Marks the world lost when a mesh operation inside fails: no
        later header (not even ``STOP``) is sent into it."""
        try:
            yield
        except MeshError:
            self._mesh_state = "lost"
            raise

    def _reduce_mesh(self, sbq, spans) -> List[torch.Tensor]:
        """One mesh flush from the controller: the ``FLUSH`` header, each
        participating worker's schedule (tile ids, and 0/1 bitmaps as
        uint8) on the control plane, then rank 0's share of the SPMD
        reduction over its own schedule (all ``-1`` when shard 0 does not
        participate)."""
        parts = [int(p) for p in sbq.shard_ids]
        _, nb, max_tiles, q_block, tile_rows = sbq.bitmaps.shape
        self._send_header(
            _OP_FLUSH, nb, max_tiles, q_block, tile_rows, self.combine_chunks,
            int(self.dynamic_switch), COMBINES.index(self.combine),
            len(parts), *parts,
        )
        for p, s in enumerate(parts):
            if s != 0:
                self.mesh.send(sbq.tile_ids[p], s)
                self.mesh.send(sbq.bitmaps[p].to(torch.uint8), s)
        if 0 in parts:
            p = parts.index(0)
            ids = _upload(sbq.tile_ids[p], self.device)
            bms = _upload(sbq.bitmaps[p], self.device)
        else:
            ids, bms = _empty_schedule(sbq.bitmaps.shape[1:], self.dtype, self.device)
        own = dataclasses.replace(sbq, tile_ids=ids[None], bitmaps=bms[None],
                                  shards=np.asarray(parts, dtype=np.int64))
        self.stats.result_bytes += result_bytes(
            self.num_shards, parts, nb * q_block, self.dim, self.combine,
            self.shard_images.element_size(),
        )
        return crossbar_reduce_tables(
            self.shard_images, own, spans, mesh=self.mesh,
            axis_name=self.axis_name, combine=self.combine,
            combine_chunks=self.combine_chunks,
            dynamic_switch=self.dynamic_switch,
        )

    # --------------------------------------------------------- replanning --

    def _apply_staged_patch(self) -> None:
        """Swaps in the patch staged during an earlier flush.

        Runs before anything is compiled against the plan (the top of a
        ``"global"`` serve, or a barrier after the pipeline drained), so
        flush *n* ran entirely under the old plan and flush *n+1* runs
        entirely under the new one.  Only the patch's tiles are copied
        into the image stack, on the server's stream; a failed copy or
        write raises (nothing is skipped).

        A failure at the injector's patch seam (before any state
        mutates) keeps the patch staged for the next barrier, up to
        ``retry.patch_retries`` times, then drops it (recorded) and
        serving continues under the live plan; under the legacy policy
        it re-raises instead.
        """
        if self._staged is None:
            return
        if self._in_flight:
            raise RuntimeError(
                "plan patch applied mid-pipeline — barrier rule violated"
            )
        if self._injector is not None:
            try:
                self._injector.on_patch()
            except Exception:
                self.stats.ledger.patch_failures += 1
                self._patch_fail_streak += 1
                if not self.retry.quarantine:
                    raise
                if self._patch_fail_streak > self.retry.patch_retries:
                    self.stats.ledger.patches_dropped += 1
                    dropped, self._staged = self._staged, None
                    self._patch_fail_streak = 0
                    if self.tracker is not None and dropped.promoted:
                        # the drop discards promotions whose Eq.-1 target
                        # status may persist: the next evaluation sees them
                        self.tracker.mark_drifted(dropped.promoted)
                return
        patch, self._staged = self._staged, None
        self._patch_fail_streak = 0
        with self._on_stream(), self._mesh_ops():
            if self.mesh is not None:
                self._send_header(_OP_PATCH)
            self.shard_images = patch_shard_images(
                self.shard_images, patch, self._fused, mesh=self.mesh
            )
        self.plan = apply_plan_patch(self.plan, patch)
        self.stats.record_patch(patch, tile_bytes=self._tile_bytes)
        if self._residency is not None:
            # paging moved groups across the hot/cold boundary: routing
            # re-snapshots residency here and only here (barrier rule)
            self._residency.refresh(self.plan)
        # slack age-out bookkeeping (DESIGN.md §6.2): demotion-only
        # patches extend the streak, any promotion resets it
        if patch.promoted:
            self._demote_streak = 0
        elif patch.demoted:
            self._demote_streak += 1
        if self.scheduler is not None:
            # ownership moved: re-derive row→home routing (pending work
            # was flushed under the old plan before we got here)
            self.scheduler.rebuild(self.plan)

    def _observe_and_stage(self, host_acts: FusedActivations, n_queries: int) -> None:
        """Feeds the tracker and stages a patch when drift crosses.

        Host-only work on the sparse compile, scheduled between a flush's
        kernel dispatch and the wait for its event.  A no-op
        (class-unchanged) patch is applied at once as a load rebase: it
        touches no device state.
        """
        if self.tracker is None:
            return
        loads = self._load_obs.loads(
            host_acts, self._tile_group, self.plan.num_groups
        )
        self.stats.load_obs_hits = self._load_obs.hits
        self.stats.load_obs_misses = self._load_obs.misses
        self.tracker.observe(loads, n_queries)
        self._maybe_stage()

    def _maybe_stage(self) -> None:
        """Stages a patch when the tracked drift crosses the threshold.

        Shared by the compiled-batch observation and the host path's
        flush: under tiering, cold-only traffic must still be able to
        stage the paging patch that warms it up.
        """
        if self._staged is not None or not self.tracker.ready:
            return
        drift = self.tracker.drift_from(
            self.plan.group_load, segments=self._segments
        )
        if drift < self.replan_cfg.threshold:
            return
        # Eq. 1 is magnitude-sensitive: evaluate the observed
        # distribution at the training-time mass, not the tracker's
        drifted = rescale_load_to_plan(
            self.tracker.load(), self.plan, self._seg_load_totals
        )
        # long demotion streaks age the accumulated slack back out
        # (untiered only: the hot tier's depth is fixed)
        shrink = (
            self.replan_cfg.slack_tiles
            if self.tiers is None
            and self.replan_cfg.shrink_streak
            and self._demote_streak >= self.replan_cfg.shrink_streak
            else None
        )
        paging = (
            self.tiers.paging_policy(self._capacity_tiles)
            if self.tiers is not None else None
        )
        # only groups with traffic since the last evaluation (plus the
        # replicated set, added inside) can change replication class
        candidates = self.tracker.drifted_groups()
        self.tracker.reset_drifted()
        patch = compute_plan_patch(
            self.plan, drifted,
            eq1_batch=self._eq1_batch,
            capacity=int(self.shard_images.shape[1]),
            shrink_slack=shrink,
            paging=paging,
            candidates=candidates,
        )
        if patch.deferred:
            self.tracker.mark_drifted(patch.deferred)
        if patch.fetched:
            # freshly resident groups may already be Eq.-1 targets: the
            # next evaluation must reconsider them
            self.tracker.mark_drifted([g for g, _ in patch.fetched])
        if patch.is_noop():
            # drift without a class change: reanchor group_load so the
            # demotion targets and the drift statistic track the
            # observed distribution
            self.plan = apply_plan_patch(self.plan, patch)
            self.stats.record_patch(patch, tile_bytes=self._tile_bytes)
            return
        self._staged = patch

    # ----------------------------------------------------------- batching --

    def submit(
        self,
        table: str,
        query: Sequence[int],
        *,
        producer=None,
    ) -> Dict[str, torch.Tensor]:
        """Buffers one query; flush behavior depends on the policy.

        Under ``"global"``: auto-flushes (synchronously) at
        ``batch_size`` buffered and returns that flush's results.  Under
        an async policy: the query routes to its home, due homes flush
        asynchronously (dispatch only), and the return value is always
        ``{}``; collect results with :meth:`drain` / :meth:`flush`.
        With the thread driver the call only validates, stamps a
        sequence id and enqueues onto the bounded hand-off queue.

        ``producer=`` names the calling stream (any hashable; ``None``
        is the default producer), lazily registered on first stamp; each
        producer owns its own per-table sequence space (DESIGN.md §10).

        The query is validated before anything is enqueued or a sequence
        id is consumed: row ids outside the table raise and leave every
        buffer and queue untouched.

        Returns:
          The flush result when a synchronous flush tripped, else ``{}``.

        Raises:
          KeyError: ``table`` is not a served table.
          IndexError: a row id falls outside ``[0, rows)``.
          RuntimeError: the server was :meth:`close`\\ d.
        """
        t0 = time.perf_counter()
        try:
            return self._submit(table, query, producer)
        finally:
            self.stats.record_submit(time.perf_counter() - t0)

    def _submit(
        self, table: str, query: Sequence[int], producer=None
    ) -> Dict[str, torch.Tensor]:
        if table not in self._buffer:  # unlocked: key set frozen at init
            raise KeyError(f"unknown table {table!r}")
        ids = np.asarray(list(query), dtype=np.int64)
        if ids.size:
            lo, hi = int(ids.min()), int(ids.max())
            if lo < 0 or hi >= self._num_rows[table]:
                raise IndexError(
                    f"query row ids [{lo}, {hi}] out of range "
                    f"[0, {self._num_rows[table]}) for table {table!r}"
                )
        if self.scheduler is not None:
            self._raise_driver_error()
            if self.policy.threaded:
                with self._stamp_lock:
                    # closed-check + stamp + driver-start are one atomic
                    # step: a close() cannot slip between a granted stamp
                    # and its hand-off accounting, and two producers'
                    # first submits cannot start two drivers
                    if self._closed:
                        raise RuntimeError(
                            "submit() on a closed server: close() "
                            "stopped the driver; drain() still serves "
                            "what was already submitted"
                        )
                    seq = self._registry.stamp(producer, table)
                    if self._driver is None:
                        self._start_driver()
                    handoff = self._handoff
                    self._e2e_t0[(table, seq)] = time.perf_counter()
                    self._pending_submits += 1
                try:
                    handoff.put(("query", table, seq, list(query)))
                finally:
                    with self._stamp_lock:
                        self._pending_submits -= 1
                return {}
            with self._stamp_lock:
                if self._closed:
                    raise RuntimeError("submit() on a closed server")
                seq = self._registry.stamp(producer, table)
                self._e2e_t0[(table, seq)] = time.perf_counter()
                self._pending_submits += 1
            try:
                # the inline engine is not re-entrant: concurrent
                # producers serialize here
                with self._engine_lock:
                    self._ingest(table, seq, query)
            finally:
                with self._stamp_lock:
                    self._pending_submits -= 1
            return {}
        with self._engine_lock:
            if self._snapshot_closed():
                raise RuntimeError("submit() on a closed server")
            self._buffer[table].append(ids.tolist())
            self._buffered += 1
            if self._buffered >= self.batch_size:
                return self.flush()
        return {}

    def register_producer(self, producer=None) -> int:
        """Pre-registers a producer label, returning its pid.

        Optional — a first ``submit(producer=...)`` registers lazily —
        but registration order is the cross-producer merge tiebreak
        (DESIGN.md §10), so callers that want a reproducible interleave
        register every label before any thread races a first stamp.
        """
        return self._registry.register(producer)

    def next_seq(self, table: str, producer=None) -> int:
        """Next LOCAL sequence id ``producer`` (default stream when
        ``None``) would stamp on ``table``; 0 for a producer that never
        submitted or after a quiesced drain's reset."""
        return self._registry.next_seq(table, producer)

    def producers(self) -> List:
        """Registered producer labels in pid (merge-tiebreak) order."""
        return self._registry.producers()

    def flush(self) -> Dict[str, torch.Tensor]:
        """Serves and clears all buffered work.

        Under ``"global"`` the buffer is cleared only after a successful
        serve, so a failed flush leaves every buffered request intact for
        retry.  Under an async policy this is a **barrier** (see
        :meth:`drain`).

        Returns:
          ``{table name: (batch, dim) reduction}`` per table with results;
          ``{}`` when nothing is buffered or in flight.  Row order within
          a table is submission order.
        """
        if self.scheduler is not None:
            return self.drain()
        with self._engine_lock:
            if self._buffered == 0:
                return {}
            out = self.serve({n: q for n, q in self._buffer.items() if q})
            self._buffer = {n: [] for n in self.names}
            self._buffered = 0
            return out

    def _ingest(self, table: str, seq: int, query) -> None:
        """Routes one stamped query by residency, then into the engine —
        the entry point shared by the inline async submit path and the
        driver's loop (the host flush appends to ``_completed``, so it
        runs where the engine runs)."""
        if self._route_host(table, seq, query):
            return
        self.scheduler.push(table, seq, query)
        self._maybe_flush()

    # ------------------------------------------- tiered host path (§9) ----

    def _route_host(self, table: str, seq: int, query) -> bool:
        """Detours a cold query into the host fetch queue.

        Every submission (hot or cold) advances the tier tick, so a
        queued cold query's deadline fires in a hot-dominated stream.
        Residency alone decides the route.  Returns True when the query
        was queued host-side.
        """
        if self._residency is None:
            return False
        self._tick += 1
        arr = np.asarray(list(query), dtype=np.int64)
        if self._residency.is_resident(table, arr):
            self._maybe_flush_host()
            # the host flush may have hit a patch barrier that paged this
            # query's group out: re-check under the post-patch residency
            # (the scheduler would raise on a cold group)
            if self._residency.is_resident(table, arr):
                self.stats.hot_queries += 1
                return False
        self.stats.host_queries += 1
        self._host_queue.push(table, seq, arr, self._tick)
        self._maybe_flush_host()
        return True

    def _maybe_flush_host(self) -> None:
        reason = self._host_queue.due(self._tick)
        if reason is None:
            return
        if reason == "deadline":
            self.stats.host_deadline_flushes += 1
        self._flush_host_queue()

    def _flush_host_queue(self, *, forced: bool = False) -> None:
        """Serves every queued cold query by the host gather+sum.

        The batch's loads feed the drift tracker first (host traffic is
        how a cold group earns its way in); when that staged a paging
        patch on an un-forced flush, a barrier follows, so cold-only
        traffic still reaches a patch-application point.  The rows go
        to the card in one copy and are stored like a retired flush's.
        ``forced`` marks the barrier's own drain (never re-enters).
        """
        if self._host_queue is None or len(self._host_queue) == 0:
            return
        entries = self._host_queue.take()
        self.stats.host_flushes += 1
        if self.tracker is not None:
            self.tracker.observe(
                self._residency.host_group_loads(entries), len(entries)
            )
            self._maybe_stage()
        by_table: Dict[str, List[tuple]] = {}
        for entry in entries:
            by_table.setdefault(entry[0], []).append(entry)
        rows = self._cold_rows([e for es in by_table.values() for e in es])
        start = 0
        for table, es in by_table.items():
            seqs = np.asarray([seq for _t, seq, _q in es], dtype=np.int64)
            self._record_completed(table, seqs, rows[start:start + len(es)])
            start += len(es)
        if not forced and self._staged is not None:
            # cold-dominated traffic may never trip a device flush; the
            # staged paging patch would otherwise wait forever
            self._barrier()

    # ------------------------------------------------- async flush engine --

    def _maybe_flush(self) -> None:
        """Dispatches every home the policy says is due.

        If a plan patch is staged, the next trigger forces a **barrier**
        instead (DESIGN.md §7.3): the pipeline drains under the old plan,
        the patch applies, and traffic resumes under the new one.
        """
        due = self.scheduler.due_homes()
        if not due:
            return
        if self._staged is not None:
            self._barrier()
            return
        for home in due:
            self._flush_home(home)

    def _flush_home(self, home, *, forced: bool = False) -> None:
        """Compiles and dispatches one home's pending batch (no block).

        The dispatch goes through the self-healing loop
        (:meth:`_heal_dispatch`); only an error the policy does not
        absorb (the legacy contract) requeues the whole batch in
        submission order — with its deadline clock intact — before
        re-raising.  ``forced`` marks barrier flushes, which do not count
        as deadline firings.
        """
        if not forced and self.scheduler.due_reason(home) == "deadline":
            self.stats.deadline_flushes += 1
        first_tick = self.scheduler.first_tick(home)
        first_wall = self.scheduler.first_wall(home)
        entries, participants = self.scheduler.take(home)
        if not entries:
            return
        try:
            admitted = self._heal_dispatch(home, entries, participants)
        except Exception:
            self.scheduler.requeue(home, entries, first_tick=first_tick,
                                   first_wall=first_wall)
            raise
        # admission is OUTSIDE the requeue guard: a retire failure while
        # trimming the pipeline must not requeue a batch that is already
        # in flight (it would be served twice)
        for entry in admitted:
            self._admit(home, entry)

    def _heal_dispatch(self, home, entries, participants) -> List[_InFlight]:
        """Self-healing dispatch of one batch (DESIGN.md §8).

        Up to ``max_retries`` in-place re-dispatches with jittered
        exponential backoff; a batch that still fails and holds > 1
        queries **bisects** (both halves heal independently); a single
        query that still fails is **quarantined** with its error in the
        ledger and dropped.  Under the legacy policy the terminal error
        re-raises instead and the caller requeues.  Returns the
        dispatched entries for the caller to admit.
        """
        policy = self.retry
        ledger = self.stats.ledger
        t_first = None
        last: Optional[Exception] = None
        for attempt in range(policy.max_retries + 1):
            try:
                entry = self._compile_and_dispatch(entries, participants)
            except (KernelError, MeshError):
                raise  # the build, the card or the world failed, not this batch
            except Exception as e:
                last = e
                if t_first is None:
                    t_first = time.perf_counter()
                if attempt < policy.max_retries:
                    pause = policy.backoff_s(attempt, self._retry_rng)
                    ledger.retries += 1
                    ledger.backoff_s += pause
                    if pause > 0:
                        time.sleep(pause)
                continue
            if t_first is not None:
                ledger.record_recovery(time.perf_counter() - t_first)
            entry.home = home
            entry.entries = entries
            entry.participants = participants
            return [entry]
        if policy.quarantine and policy.bisect and len(entries) > 1:
            ledger.bisections += 1
            mid = len(entries) // 2
            return (self._heal_dispatch(home, entries[:mid], participants)
                    + self._heal_dispatch(home, entries[mid:], participants))
        if policy.quarantine:
            # terminal: drop the offender(s), keep the home serving
            for table, seq, _query in entries:
                prod, local = self._registry.decode(seq)
                ledger.quarantine(table, local, last, producer=prod)
                self._e2e_t0.pop((table, seq), None)
            self.scheduler.record_quarantine(len(entries))
            return []
        raise last

    def _admit(self, home, entry: _InFlight) -> None:
        """Enqueues one dispatched flush and trims the pipeline."""
        self._in_flight.append(entry)
        # peak is sampled at APPEND time — the queue transiently holds
        # max_in_flight + 1 entries before the retire loop trims it
        self.stats.in_flight_peak = max(
            self.stats.in_flight_peak, len(self._in_flight)
        )
        self.stats.record_flush_home(home)
        # drift bookkeeping is host work on the sparse compile: it overlaps
        # this flush's kernels exactly like the next flush's compile does
        self._observe_and_stage(entry.host_acts, entry.n_queries)
        while len(self._in_flight) > self.policy.max_in_flight:
            self._retire_oldest()

    def _device_busy(self) -> bool:
        """Whether any in-flight flush is still running on the card.

        Feeds ``hidden_compile_s``, whose contract is a conservative
        LOWER bound on overlapped compile time — so an entry with no
        event counts as idle, never as busy.
        """
        return any(not self._entry_ready(e) for e in self._in_flight)

    def _compile_and_dispatch(
        self,
        entries: List[tuple],
        participants: List[int] | None,
    ) -> _InFlight:
        """Host-compiles a batch and dispatches its kernels, non-blocking.

        The host compile runs while earlier flushes may still run on the
        card; ``record_compile(hidden=...)`` samples that overlap at
        compile END (a conservative lower bound).  The schedule's copy to
        the card is pinned and non-blocking, so nothing here waits for the
        card; the flush's event is recorded after its last kernel and
        waited on only at hand-off (:meth:`_retire_oldest`).

        Mutates no engine state besides stats — a raise leaves the
        pipeline as it was (the caller retries or requeues).  The fault
        injector's compile seam fires before the compile and its
        dispatch seam between compile and kernel dispatch; an injected
        hang tags the entry so readiness polling simulates a hung card.
        """
        t0 = time.perf_counter()
        if self._injector is not None:
            self._injector.on_compile(entries)
        by_table: Dict[str, Tuple[List[int], List[list]]] = {}
        for table, seq, query in entries:
            seqs, qs = by_table.setdefault(table, ([], []))
            seqs.append(seq)
            qs.append(query)
        served = [n for n in self.names if n in by_table]
        with self._on_stream():
            host_acts, sbq, spans = self._compile_batch(
                served, {n: by_table[n][1] for n in served},
                participants=participants,
            )
            self.stats.record_compile(
                time.perf_counter() - t0, hidden=self._device_busy()
            )
            hang_s = (
                self._injector.on_dispatch() if self._injector is not None
                else None
            )
            outs = self._reduce(sbq, spans)
            event = self._record_event()
        return _InFlight(
            outs=outs, sbq=sbq, served=served,
            seqs={n: np.asarray(by_table[n][0], dtype=np.int64)
                  for n in served},
            t0=t0, n_queries=sum(len(by_table[n][1]) for n in served),
            host_acts=host_acts, event=event, t_dispatch=time.perf_counter(),
            hang_s=hang_s,
        )

    def _retire_oldest(self) -> None:
        """Retires the oldest in-flight flush and stashes its rows.

        A watchdog timeout degrades the flush to the host path on a CPU
        server; on the card it requeues the flush's batch at its home and
        re-raises (the host never serves rows the card was asked for).  A
        retire-time device fault re-enters the healing loop under the
        default policy, or requeues + re-raises under the legacy one.
        """
        e = self._in_flight.popleft()
        try:
            if self._injector is not None:
                self._injector.on_retire()
            outs = self._wait_outputs(e)
        except FlushTimeout:
            if self._host_tables is None:
                self.stats.ledger.timed_out_flushes += 1
                if e.entries is not None:
                    self.scheduler.requeue(e.home, e.entries)
                raise
            self._degrade(e)
            return
        except Exception:
            if self.retry.quarantine and e.entries is not None:
                # late device fault: the outputs are lost but the raw
                # batch is not — heal it like a dispatch-time failure
                self.stats.ledger.retries += 1
                try:
                    healed = self._heal_dispatch(
                        e.home, e.entries, e.participants
                    )
                except (KernelError, MeshError):
                    self.scheduler.requeue(e.home, e.entries)
                    raise
                for entry in healed:
                    self._admit(e.home, entry)
                return
            if e.entries is not None:
                self.scheduler.requeue(e.home, e.entries)
            raise
        self.stats.record(
            e.sbq, self.dim, time.perf_counter() - e.t0, e.n_queries
        )
        for name, out in zip(e.served, outs):
            self._record_completed(name, e.seqs[name], out)

    def _record_completed(
        self, table: str, seqs: np.ndarray, rows: torch.Tensor
    ) -> None:
        """Stashes one flush's rows (on the device) for :meth:`drain` and
        samples e2e latency, under the results lock."""
        now = time.perf_counter()
        for s in seqs:
            t0 = self._e2e_t0.pop((table, int(s)), None)
            if t0 is not None:
                self.stats.e2e_wall.append(now - t0)
        with self._results_lock:
            self._completed[table].append((seqs, rows))

    def _wait_outputs(self, e: _InFlight) -> List[torch.Tensor]:
        """Waits for one flush's event, bounded by the watchdog.

        Without a watchdog (and without an injected hang) this is
        ``event.synchronize()``.  With one, readiness is polled and
        :class:`~repro_torch.serve.faults.FlushTimeout` raises once
        ``watchdog_s`` has elapsed since the flush's kernel DISPATCH.  An
        injected infinite hang with no watchdog times out at once.
        """
        wd = self.retry.watchdog_s
        if wd is None and e.hang_s is None:
            if e.event is not None:
                e.event.synchronize()
            return e.outs
        while not self._entry_ready(e):
            waited = time.perf_counter() - e.t_dispatch
            if wd is not None and waited >= wd:
                raise FlushTimeout(
                    f"flush not ready {waited:.3f}s after dispatch "
                    f"(watchdog {wd}s)"
                )
            if wd is None and e.hang_s == math.inf:
                raise FlushTimeout(
                    "flush hung forever with no watchdog configured"
                )
            time.sleep(self.retry.watchdog_poll_s)
        return e.outs

    def _degrade(self, e: _InFlight) -> None:
        """Serves one timed-out flush via the host gather+sum path (CPU
        servers only).

        The timed-out outputs are abandoned and every query of the flush
        is recomputed over the host copy of its logical table (distinct
        rows summed, empty bags zero), cast to the table's dtype, so
        ``drain()`` still returns every row.  Recorded as a degraded +
        timed-out flush in the ledger.
        """
        ledger = self.stats.ledger
        ledger.timed_out_flushes += 1
        ledger.degraded_flushes += 1
        if e.entries is None:  # no raw batch — nothing to recompute from
            raise FlushTimeout(
                "timed-out flush carries no raw batch to degrade with"
            )
        rows_of: Dict[str, Tuple[List[int], List[np.ndarray]]] = {}
        for table, seq, query in e.entries:
            ids = np.unique(np.asarray(list(query), dtype=np.int64))
            tab = self._host_tables[table]
            row = (tab[ids].sum(axis=0) if ids.size
                   else np.zeros(self.dim, dtype=tab.dtype))
            seqs, rows = rows_of.setdefault(table, ([], []))
            seqs.append(seq)
            rows.append(row.astype(tab.dtype, copy=False))
        for table, (seqs, rows) in rows_of.items():
            dev_rows = torch.from_numpy(np.stack(rows)).to(
                device=self.device, dtype=self.dtype
            )
            self._record_completed(
                table, np.asarray(seqs, dtype=np.int64), dev_rows
            )
        self.stats.record(
            e.sbq, self.dim, time.perf_counter() - e.t0, e.n_queries
        )

    def _barrier(self) -> None:
        """Flush-everything + drain + apply any staged patch.

        Pending queries compile under the plan they were routed against;
        only after every dispatched flush retires does the staged patch
        swap placement arrays and images and the scheduler re-derive its
        routing.  With the thread driver running, a caller on any other thread posts a barrier token onto
        the hand-off queue and joins the driver at it: the driver first
        drains every earlier hand-off item (FIFO), then runs this barrier
        inline.
        """
        driver = self._driver
        if (driver is not None
                and threading.current_thread() is not driver):
            handoff = self._handoff
            if handoff is not None:
                done = threading.Event()
                handoff.put(("barrier", done))
                # never wait forever on a driver that died or was
                # closed under us — poll its liveness while waiting
                while not done.wait(0.1):
                    if self._driver is not driver or not driver.is_alive():
                        break
                self._raise_driver_error()
                return
        for home in self.scheduler.homes_with_pending():
            self._flush_home(home, forced=True)
        while self._in_flight:
            self._retire_oldest()
        # queued cold work drains with the pipeline, so a drain hands
        # back every submitted query's row
        self._flush_host_queue(forced=True)
        self._apply_staged_patch()
        self.stats.barrier_flushes += 1

    # ------------------------------------------------------ thread driver --

    def _start_driver(self) -> None:
        self._handoff = queue.Queue(maxsize=self.policy.handoff_depth)
        self._driver_stop = threading.Event()
        self._driver = threading.Thread(
            target=self._driver_loop, name="recross-flush-driver", daemon=True
        )
        self._driver.start()

    def _driver_loop(self) -> None:
        """Dispatch/retire loop of the thread driver (DESIGN.md §7.2).

        Runs on the server's device and stream throughout.  Pops
        hand-off items FIFO: a query item routes + maybe-flushes, a
        barrier token runs :meth:`_barrier` inline and wakes its waiter.
        While the queue is idle, in-flight flushes whose events completed
        retire opportunistically, and a wall deadline gets its chance to
        fire.  A failure is stashed for :meth:`_raise_driver_error` to
        surface on the caller's thread.
        """
        with self._on_stream():
            while not self._driver_stop.is_set():
                try:
                    item = self._handoff.get(timeout=0.005)
                except queue.Empty:
                    try:
                        self._retire_ready()
                        if self.policy.deadline_s is not None:
                            self._maybe_flush()
                    except Exception as e:  # device fault surfacing at retire
                        self._stash_driver_error(e)
                    continue
                if item[0] == "barrier":
                    done = item[1]
                    try:
                        self._barrier()
                    except Exception as e:
                        self._stash_driver_error(e)
                    finally:
                        # task_done BEFORE waking the waiter: the seq-reset
                        # guard reads unfinished_tasks right after a drain's
                        # barrier returns, and this token must not count
                        self._handoff.task_done()
                        done.set()
                    continue
                _, table, seq, query_list = item
                try:
                    self._ingest(table, seq, query_list)
                except Exception as e:
                    # the batch is already requeued; surface the failure
                    # at the caller's next submit()/drain()
                    self._stash_driver_error(e)
                finally:
                    # a popped-but-unprocessed item is invisible to both
                    # empty() and the scheduler — unfinished_tasks is the
                    # counter that still sees it (seq-reset guard)
                    self._handoff.task_done()

    def _retire_ready(self) -> None:
        """Retires in-flight flushes whose events completed, oldest
        first; with a watchdog, a hung HEAD entry past its deadline is
        retired here (taking the degrade path) while the driver idles."""
        while self._in_flight and self._entry_ready(self._in_flight[0]):
            self._retire_oldest()
        wd = self.retry.watchdog_s
        if (wd is not None and self._in_flight
                and time.perf_counter() - self._in_flight[0].t_dispatch >= wd):
            self._retire_oldest()

    @staticmethod
    def _entry_ready(e: _InFlight) -> bool:
        # an injected hang: not ready until hang_s after dispatch
        if e.hang_s is not None and (
            time.perf_counter() - e.t_dispatch
        ) < e.hang_s:
            return False
        # no event: CPU tensors (already computed) or a test stub
        return e.event is None or bool(e.event.query())

    def _stash_driver_error(self, e: BaseException) -> None:
        """Stashes one driver failure for the caller's thread, bounded:
        later ones queue behind the first (up to
        :data:`_MAX_STASHED_ERRORS`), overflow is counted in the ledger."""
        if len(self._driver_errors) < _MAX_STASHED_ERRORS:
            self._driver_errors.append(e)
        else:
            self._suppressed_errors += 1
            self.stats.ledger.driver_errors_suppressed += 1

    def _raise_driver_error(self) -> None:
        """Re-raises the OLDEST failure stashed by the driver thread,
        its message carrying the count of further failures stashed (and
        suppressed)."""
        if not self._driver_errors:
            return
        err = self._driver_errors.popleft()
        more = len(self._driver_errors) + self._suppressed_errors
        if more and err.args and isinstance(err.args[0], str):
            suppressed = (
                f", {self._suppressed_errors} suppressed past the stash "
                f"bound" if self._suppressed_errors else ""
            )
            err.args = (
                f"{err.args[0]} [+{more} more driver failure(s) "
                f"stashed{suppressed}]",
            ) + err.args[1:]
        raise err

    #: driver join bound at close(); a driver stuck in un-watchdogged
    #: device work is abandoned (daemon thread) rather than wedging the
    #: caller, and the leak is recorded in the ledger's lost-work summary
    _CLOSE_JOIN_S = 30.0

    def close(self) -> None:
        """Stops the thread driver (if running) and closes the front
        door: any later :meth:`submit` — including one racing this call
        on another thread — gets a clean ``RuntimeError``.  Hand-off
        items the driver had not yet popped are pushed back into the
        scheduler, so no submitted query is dropped — a later
        :meth:`drain` serves them inline (the driver does not restart).

        Idempotent and bounded: the driver join never hangs past
        :data:`_CLOSE_JOIN_S`, and a producer blocked in a full hand-off
        ``put()`` is unblocked by the push-back loop.  Work still
        unserved at close is summarized into the ledger's ``lost_work``.
        Under a mesh, ``STOP`` ends every worker's :func:`serve_worker`;
        a later drain returns what was already served and raises if it
        would have to dispatch.
        """
        with self._stamp_lock:
            already = self._closed
            self._closed = True
        if already:
            return
        leaked = False
        if self._driver is not None:
            self._driver_stop.set()
            self._driver.join(timeout=self._CLOSE_JOIN_S)
            leaked = self._driver.is_alive()
            self._driver = None
        pushed_back = 0
        if self._handoff is not None:
            # drain until no producer is still inside put(): every get
            # below frees a slot, so a submitter blocked on the full
            # queue completes its put and exits via _pending_submits
            while True:
                try:
                    item = self._handoff.get_nowait()
                except queue.Empty:
                    with self._stamp_lock:
                        if (self._pending_submits == 0
                                and self._handoff.empty()):
                            break
                    time.sleep(0.001)
                    continue
                if item[0] == "barrier":
                    # a concurrent drain()'s token: wake the waiter (its
                    # barrier re-runs inline once the driver is gone)
                    item[1].set()
                else:
                    _, table, seq, query_list = item
                    self.scheduler.push(table, seq, query_list)
                    pushed_back += 1
            self._handoff = None
        if self.scheduler is not None:
            requeued = self.scheduler.pending_total()
        else:
            with self._engine_lock:
                requeued = self._buffered
        unserved = {
            "requeued": requeued,
            "handoff_pushed_back": pushed_back,
            "in_flight": len(self._in_flight),
            "host_pending": (len(self._host_queue)
                             if self._host_queue is not None else 0),
            "stashed_errors": len(self._driver_errors),
            "driver_leaked": int(leaked),
        }
        if any(unserved.values()):
            self.stats.ledger.lost_work = unserved
        if self.mesh is not None and self._mesh_state == "live":
            # the workers leave serve_worker(); nothing is dispatched after
            self._send_header(_OP_STOP)
            self._mesh_state = "stopped"

    def __enter__(self) -> "ShardedEmbeddingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def drain(self, producer=None) -> Dict[str, torch.Tensor]:
        """Barrier + result hand-off for async policies.

        Flushes every pending home, retires the whole in-flight queue,
        applies a staged plan patch and returns everything served since
        the previous hand-off.
        Under the thread driver this joins the driver at a barrier
        token; a failure stashed by the driver surfaces here.

        With ``producer=None`` (a FULL drain) every completed row is
        returned, merged per table in the deterministic ``(local_seq,
        producer_id)`` order (DESIGN.md §10).  With ``producer=`` a
        label, only that producer's rows return (in ITS submission
        order); every other stream's rows stay stashed for its own drain.

        Returns:
          ``{table: (n_queries, dim)}`` tensors on the server's device,
          merged on its stream; ``{}`` for tables with no completed work
          (for this producer).

        Raises:
          ValueError: ``producer=`` under the ``"global"`` policy.
        """
        if self.scheduler is None:
            if producer is not None:
                raise ValueError(
                    "drain(producer=...) needs an async flush policy"
                )
            return self.flush()
        self._raise_driver_error()
        if self._driver is not None:
            self._barrier()
        else:
            # inline engine: serialize against concurrent submits
            with self._engine_lock:
                self._barrier()
        out: Dict[str, torch.Tensor] = {}
        with self._results_lock, self._on_stream():
            if producer is None:
                for name in self.names:
                    chunks = self._completed[name]
                    if not chunks:
                        continue
                    seqs = np.concatenate([c[0] for c in chunks])
                    rows = torch.cat([c[1] for c in chunks])
                    # packed ids sort as (local_seq, producer_id): the
                    # cross-producer merge is deterministic, and within
                    # one producer it is that producer's FIFO
                    out[name] = _take_rows(rows, np.argsort(seqs))
                self._completed = {n: [] for n in self.names}
            else:
                pid = self._registry.pid(producer)
                stride = self._registry.stride
                for name in self.names:
                    chunks = self._completed[name]
                    if not chunks or pid is None:
                        continue
                    seqs = np.concatenate([c[0] for c in chunks])
                    rows = torch.cat([c[1] for c in chunks])
                    mine = np.nonzero((seqs % stride) == pid)[0]
                    if mine.size:
                        out[name] = _take_rows(
                            rows, mine[np.argsort(seqs[mine])]
                        )
                    rest = np.nonzero((seqs % stride) != pid)[0]
                    self._completed[name] = (
                        [(seqs[rest], _take_rows(rows, rest))]
                        if rest.size else []
                    )
        # sequence ids restart ONLY at full quiescence — nothing pending,
        # in flight, queued host-side, stashed for another producer's
        # drain, or still
        # inside a submit()'s stamped-but-undelivered window (the
        # hand-off's unfinished_tasks counts popped-but-unprocessed items
        # too).  Per-producer drains never reset.
        if producer is None:
            with self._results_lock:
                with self._stamp_lock:
                    handoff = self._handoff
                    busy = (
                        self._pending_submits > 0
                        or (handoff is not None
                            and handoff.unfinished_tasks > 0)
                    )
                    if (not busy
                            and self.scheduler.pending_total() == 0
                            and not self._in_flight
                            and (self._host_queue is None
                                 or len(self._host_queue) == 0)
                            and not any(self._completed.values())):
                        # opt-in structural validation at quiescence
                        # (RECROSS_VALIDATE=1, DESIGN.md §12) — the one
                        # moment every invariant must hold at once; it
                        # reads device tensors by shape only
                        from repro_torch.analysis.invariants import (
                            validate_server_state,
                            validation_enabled,
                        )

                        if validation_enabled():
                            validate_server_state(self, quiesced=True)
                        self._registry.reset_seqs()
        return out

    # ------------------------------------------------------------- report --

    def _snapshot_closed(self) -> bool:
        """Reads the closed flag under the stamp lock that guards it."""
        with self._stamp_lock:
            return self._closed

    def report(self) -> Dict[str, object]:
        """Serving + placement accounting.

        Returns a dict with ``tables`` (sorted names), ``plan``
        (:meth:`ShardPlan.memory_summary`), ``serve``
        (:meth:`ShardedServeStats.summary`, the error ledger inside
        ``serve["faults"]``), ``mode`` (``"shard_map"`` under a mesh, as
        the reference reports it, else ``"emulated"``), ``retry`` (the
        live :class:`RetryPolicy` knobs), ``dispatch_cache`` (the
        reference's schema; the mesh's subgroup cache under
        ``"mesh_subset"``), ``device``, ``image_bytes`` (the shard image
        stack on the device; this rank's shard under a mesh), under a
        mesh ``mesh`` (ranks, backend, combine, the point-to-point
        ``result_bytes``), with ``tiers=`` ``tiers``
        (capacity, hysteresis, cold groups and tiles, resident groups,
        the host queue), with ``faults=`` ``faults`` (the plan and the
        per-seam attempt and injection counters), under an async policy
        ``scheduler`` (policy knobs, pipeline depth, pending/fill and
        producers) and, with ``replan=``, ``replan`` (drift against the
        live plan, tracker readiness, the staged patch's summary, image
        capacity and slack).
        """
        rep: Dict[str, object] = {
            "tables": self.names,
            "plan": self.plan.memory_summary(),
            "serve": self.stats.summary(),
            "mode": "shard_map" if self.mesh is not None else "emulated",
            "retry": dataclasses.asdict(self.retry),
            "dispatch_cache": dispatch_cache_stats(self.mesh),
            "device": str(self.device),
            "image_bytes": self.shard_images.numel() * self.shard_images.element_size(),
        }
        if self.mesh is not None:
            rep["mesh"] = {
                "ranks": self.mesh.size,
                "backend": self.mesh.backend,
                "combine": self.combine,
                "result_bytes": self.stats.result_bytes,
                "workers": self._mesh_state,
            }
        if self.tiers is not None:
            plan = self.plan
            rep["tiers"] = {
                "capacity_tiles": self._capacity_tiles,
                "hysteresis": self.tiers.hysteresis,
                "cold_groups": int(plan.cold_groups.size),
                "cold_tiles": plan.cold_tiles,
                "resident_groups": int(plan.resident_group.sum()),
                "host_queue": self._host_queue.state(),
            }
        if self._injector is not None:
            rep["faults"] = self._injector.summary()
        if self.scheduler is not None:
            rep["scheduler"] = {
                "policy": self.policy.kind,
                "batch_size": self.policy.batch_size,
                "union_budget": self.policy.union_budget,
                "deadline": self.policy.deadline,
                "deadline_s": self.policy.deadline_s,
                "max_in_flight": self.policy.max_in_flight,
                "in_flight": len(self._in_flight),
                "threaded": self.policy.threaded,
                "handoff_depth": self.policy.handoff_depth,
                "handoff_pending": (
                    self._handoff.qsize() if self._handoff is not None else 0
                ),
                "closed": self._snapshot_closed(),
                **self.scheduler.state(),
                "producers": self._registry.state(),
            }
        if self.tracker is not None:
            # one snapshot of what a barrier on the driver may swap
            plan, staged = self.plan, self._staged
            capacity = int(self.shard_images.shape[1])
            rep["replan"] = {
                "threshold": self.replan_cfg.threshold,
                "half_life": self.replan_cfg.half_life,
                "drift": self.tracker.drift_from(
                    plan.group_load, segments=self._segments
                ),
                "observed_queries": self.tracker.observed_queries,
                "ready": self.tracker.ready,
                "staged": staged.summary() if staged is not None else None,
                "image_capacity": capacity,
                # free headroom above the highest allocated slot — what
                # slack age-out (shrink_streak) reclaims
                "slack_slots": capacity - plan.max_local_tiles,
                "demote_streak": self._demote_streak,
            }
        return rep


# ---------------------------------------------------------------- mesh --

#: control-plane header ops (see the module docstring)
_OP_IMAGE, _OP_FLUSH, _OP_PATCH, _OP_STOP = 1, 2, 3, 4


def _header_len(num_shards: int) -> int:
    """A header is the op, eight FLUSH fields and the participants."""
    return 9 + num_shards


def _upload(t: torch.Tensor, device) -> torch.Tensor:
    """A CPU tensor on ``device``; to a card through pinned memory with
    ``non_blocking=True``, so the host waits for no queued kernel."""
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _empty_schedule(shape, dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A non-participant's schedule: ``(nb, max_tiles)`` ids all ``-1``
    and zero ``(nb, max_tiles, q_block, tile_rows)`` bitmaps."""
    ids = torch.full(tuple(shape[:2]), -1, dtype=torch.int32, device=device)
    return ids, torch.zeros(tuple(shape), dtype=dtype, device=device)


def serve_worker(mesh: ShardMesh) -> Dict[str, int]:
    """The loop of every rank but 0 under a mesh server.

    Blocks on the controller's headers and serves them until ``STOP``:
    ``IMAGE`` receives this rank's image shard; ``FLUSH`` receives this
    rank's schedule when it participates (a non-participant takes an
    all ``-1`` one), runs the kernel and joins the combine; ``PATCH``
    resizes the shard and writes its tiles of a plan patch.  Runs on the
    device and stream current when called.  An exception propagates,
    and the world is then lost: rank 0's next transfer fails, or times
    out.

    Returns:
      ``{"flushes", "patches"}``: the counts served.
    """
    if mesh.rank == 0:
        raise ValueError("rank 0 runs the ShardedEmbeddingServer, not serve_worker()")
    image: Optional[torch.Tensor] = None
    served = {"flushes": 0, "patches": 0}
    n = _header_len(mesh.size)
    while True:
        op, *h = mesh.broadcast_header(length=n)
        if op == _OP_STOP:
            return served
        if op == _OP_IMAGE:
            image = distribute_shard_images(None, mesh)
        elif op == _OP_PATCH:
            image = patch_shard_images(image, None, None, mesh=mesh)
            served["patches"] += 1
        elif op == _OP_FLUSH:
            nb, max_tiles, q_block, tile_rows, chunks, switch, combine, p = h[:8]
            parts = h[8:8 + p]
            shape = (nb, max_tiles, q_block, tile_rows)
            if mesh.rank in parts:
                ids = mesh.recv(shape[:2], torch.int32).to(mesh.device)
                bms = mesh.recv(shape, torch.uint8).to(mesh.device).to(image.dtype)
            else:
                ids, bms = _empty_schedule(shape, image.dtype, mesh.device)
            crossbar_reduce_sharded(
                image, ids[None], bms[None], mesh=mesh,
                combine=COMBINES[combine], combine_chunks=chunks,
                dynamic_switch=bool(switch), shard_ids=parts,
            )
            served["flushes"] += 1
        else:
            raise MeshError(f"unknown control header op {op}")


def _take_rows(rows: torch.Tensor, index: np.ndarray) -> torch.Tensor:
    """``rows[index]`` with a host index, gathered on ``rows``' device."""
    return rows.index_select(
        0, torch.as_tensor(index, dtype=torch.int64, device=rows.device)
    )
