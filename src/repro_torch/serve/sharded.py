"""Sharded multi-table embedding serving driver, synchronous path.

The port of ``repro.serve.sharded`` under the ``"global"`` flush policy
(DESIGN.md §4).  Glues the offline pipeline to the sharded online path
for a *set* of DLRM embedding tables:

  per table: history → co-occurrence → grouping (Alg. 1) → Eq.-1
  log-scaled replication → layout, then one :class:`~repro_torch.dist.
  shard_plan.ShardPlan` over the fused tile space and one stacked shard
  image, allocated once on the device.

Requests accumulate per table in the server's buffer; at ``batch_size``
buffered queries (or on :meth:`flush`) each table's batch is compiled on
the host (block-granular replica choice), rebased into the fused tile
space, block-compiled per shard, and reduced by
:func:`repro_torch.kernels.sharded.crossbar_reduce_tables` — the CUDA
crossbar kernel once per shard and combine chunk, combined in float32.

Not ported yet, and refused with ``NotImplementedError`` naming the slice
that brings them: the async flush policies and thread driver (scheduler
slice), online replanning (drift/replan slice), tiered storage and fault
injection (tiers and faults slice), and ``mesh=`` (``torch.distributed``
slice).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.core.cooccurrence import build_cooccurrence
from repro_torch.core.grouping import correlation_aware_grouping
from repro_torch.core.mapping import build_layout
from repro_torch.core.reduction import (
    compile_queries,
    concat_compiled_queries,
    offset_compiled_queries,
    shard_block_queries,
)
from repro_torch.core.replication import plan_replication
from repro_torch.dist.shard_plan import ShardPlan, build_fused_image, plan_shards
from repro_torch.kernels.sharded import (
    combine_bytes_per_batch,
    crossbar_reduce_tables,
    dispatch_cache_stats,
)


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


@dataclasses.dataclass
class ShardedServeStats:
    """Accumulated per-flush accounting of the sharded datapath.

    Latency samples are kept raw (one float per flush / per submit) so
    :meth:`summary` can report percentiles.
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
    participant_sizes: Dict[int, int] = dataclasses.field(default_factory=dict)
    host_compile_s: float = 0.0            # Σ per-flush host compile time
    flush_wall: List[float] = dataclasses.field(default_factory=list)
    submit_wall: List[float] = dataclasses.field(default_factory=list)
    unserved_at_close: int = 0             # buffered queries close() dropped

    def record(self, sbq, dim: int, wall_s: float, queries: int) -> None:
        """Accounts one served batch: grid cells, widths, combine
        traffic, wall time."""
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

    def summary(self) -> Dict[str, object]:
        """Flat metrics dict for reports (counters, latency percentiles)."""
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
            "participant_sizes": {
                str(k): v for k, v in sorted(self.participant_sizes.items())
            },
            "flush_latency_s": latency_percentiles(self.flush_wall),
            "submit_latency_s": latency_percentiles(self.submit_wall),
            "host_compile_s": self.host_compile_s,
            "unserved_at_close": self.unserved_at_close,
        }


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported yet; it comes with the {slice_name} slice "
        "of the PyTorch port"
    )


def _host_table(t: torch.Tensor) -> np.ndarray:
    """Host copy for the plan/image build (bf16 widens to float32, which
    the permutation-only image build carries exactly)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class ShardedEmbeddingServer:
    """Multi-table embedding-reduction server, synchronous global flushes.

    Args:
      tables: ``{name: (rows, dim) tensor}`` logical tables
        (:func:`repro_torch.convert.tables_from_numpy` makes them from the
        JAX side's arrays).  The image keeps their dtype.
      histories: ``{name: ragged lookup history}`` driving the offline
        pipeline (grouping + Eq.-1 replication) per table.
      num_shards: shards to plan for; emulated on one device.
      q_block: queries per kernel block.
      group_size: crossbar height (tile rows).
      batch_size: auto-flush threshold for :meth:`submit`.
      batch_size_for_eq1: Eq. 1's ``batch``; defaults to ``batch_size``.
      combine_chunks: block-axis chunks (one kernel launch each per shard).
      dynamic_switch: enable the paper's §III-D READ/MAC switch.
      device: where the shard images live and the kernels run.
      mesh, flush_policy, replan, tiers, faults, threaded: the reference
        server's other modes; anything but the defaults raises
        ``NotImplementedError`` naming the slice that ports it.
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
        mesh=None,
        flush_policy: str = "global",
        replan=None,
        tiers=None,
        faults=None,
        threaded: bool = False,
    ):
        if mesh is not None:
            raise _not_ported("mesh= (one shard per device)", "torch.distributed")
        if flush_policy != "global" or threaded:
            raise _not_ported(
                f"flush_policy={flush_policy!r} threaded={threaded}",
                "scheduler / thread driver",
            )
        if replan is not None:
            raise _not_ported("replan=", "drift/replan")
        if tiers is not None or faults is not None:
            raise _not_ported("tiers= / faults=", "tiers and faults")
        if set(tables) != set(histories):
            raise ValueError("tables and histories must cover the same names")
        if not tables:
            raise ValueError("need at least one table")
        self.names = sorted(tables)
        self.num_shards = num_shards
        self.q_block = q_block
        self.batch_size = batch_size
        self.combine_chunks = combine_chunks
        self.dynamic_switch = dynamic_switch
        self.device = torch.device(device)

        dtypes = {tables[n].dtype for n in self.names}
        if len(dtypes) != 1:
            raise ValueError("fused serving requires a uniform table dtype")
        self.dtype = dtypes.pop()
        eq1_batch = batch_size_for_eq1 or batch_size
        host = {n: _host_table(tables[n]) for n in self.names}
        self.layouts, plans, gfreqs = [], [], []
        dims = set()
        for name in self.names:
            table = host[name]
            graph = build_cooccurrence(histories[name], table.shape[0])
            grouping = correlation_aware_grouping(graph, group_size)
            plan = plan_replication(grouping, graph.freq, eq1_batch)
            self.layouts.append(build_layout(grouping, plan, table.shape[1]))
            plans.append(plan)
            gfreqs.append(grouping.group_freq(graph.freq))
            dims.add(table.shape[1])
        if len(dims) != 1:
            raise ValueError("fused serving requires a uniform embedding dim")
        self.dim = dims.pop()
        self.plan: ShardPlan = plan_shards(
            self.layouts, plans, num_shards, names=self.names, group_freqs=gfreqs,
        )
        fused = build_fused_image(self.layouts, [host[n] for n in self.names])
        images = self.plan.build_shard_images(fused)
        del fused, host
        #: (num_shards, max_local_tiles, tile_rows, dim), allocated once
        self.shard_images = torch.from_numpy(images).to(
            device=self.device, dtype=self.dtype
        )
        del images
        self.stats = ShardedServeStats(num_shards=num_shards, q_block=q_block)
        self._num_rows = {n: int(tables[n].shape[0]) for n in self.names}
        self._buffer: Dict[str, List[List[int]]] = {n: [] for n in self.names}
        self._buffered = 0
        self._closed = False
        # serializes buffer mutation and flushes under concurrent submits
        self._lock = threading.RLock()

    # ------------------------------------------------------------ serving --

    def serve(
        self, queries_by_table: Dict[str, Sequence[Sequence[int]]]
    ) -> Dict[str, torch.Tensor]:
        """Serves one synchronous multi-table batch.

        Compiles each table's ragged queries on the host, rebases them
        into the fused tile space, block-compiles per shard, runs the
        sharded kernel and waits for it on the outputs' stream.

        Args:
          queries_by_table: ``{table name: ragged row-id queries}``;
            tables absent or mapped to an empty list are skipped.

        Returns:
          ``{table name: (batch, dim) reduction}`` on the server's device
          for every table that had at least one query.

        Raises:
          KeyError: a key names an unknown table.
        """
        t0 = time.perf_counter()
        unknown = set(queries_by_table) - set(self.names)
        if unknown:
            raise KeyError(f"unknown tables {sorted(unknown)!r}")
        served = [n for n in self.names if queries_by_table.get(n)]
        if not served:
            return {}
        queries_of = {n: list(queries_by_table[n]) for n in served}
        tc = time.perf_counter()
        sbq, spans = self._compile_batch(served, queries_of)
        self.stats.host_compile_s += time.perf_counter() - tc
        outs = crossbar_reduce_tables(
            self.shard_images, sbq, spans,
            combine_chunks=self.combine_chunks,
            dynamic_switch=self.dynamic_switch,
        )
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.stats.record(
            sbq, self.dim, time.perf_counter() - t0,
            sum(len(queries_of[n]) for n in served),
        )
        return dict(zip(served, outs))

    def _compile_batch(self, served, queries_of):
        """Fused host compile: per-table compile (block-granular replica
        choice) → rebase into the fused tile space → concat (blocks never
        span tables) → per-shard block compile, moved to the device.

        Returns ``(sbq, spans)``.
        """
        cqs = []
        for name in served:
            i = self.names.index(name)
            cq = compile_queries(
                self.layouts[i], queries_of[name],
                replica_block=self.q_block, dtype=self.dtype, device="cpu",
            )
            cqs.append(offset_compiled_queries(cq, self.plan.tables[i].tile_offset))
        fused_cq, spans = concat_compiled_queries(cqs, self.q_block)
        sbq = shard_block_queries(
            fused_cq, self.plan, self.q_block, device=self.device
        )
        return sbq, spans

    # ----------------------------------------------------------- batching --

    def submit(self, table: str, query: Sequence[int]) -> Dict[str, torch.Tensor]:
        """Buffers one query; auto-flushes at ``batch_size`` buffered.

        The query is validated before it is buffered: row ids outside the
        table raise and leave the buffer untouched.

        Returns:
          The flush result (see :meth:`flush`) when a flush tripped,
          else ``{}``.

        Raises:
          KeyError: ``table`` is not a served table.
          IndexError: a row id falls outside ``[0, rows)``.
          RuntimeError: the server was closed.
        """
        t0 = time.perf_counter()
        try:
            if table not in self._buffer:
                raise KeyError(f"unknown table {table!r}")
            ids = np.asarray(list(query), dtype=np.int64)
            if ids.size:
                lo, hi = int(ids.min()), int(ids.max())
                if lo < 0 or hi >= self._num_rows[table]:
                    raise IndexError(
                        f"query row ids [{lo}, {hi}] out of range "
                        f"[0, {self._num_rows[table]}) for table {table!r}"
                    )
            with self._lock:
                if self._closed:
                    raise RuntimeError("submit() on a closed server")
                self._buffer[table].append(ids.tolist())
                self._buffered += 1
                if self._buffered >= self.batch_size:
                    return self.flush()
            return {}
        finally:
            self.stats.submit_wall.append(time.perf_counter() - t0)

    def flush(self) -> Dict[str, torch.Tensor]:
        """Serves and clears all buffered work.

        The buffer is cleared only after a successful serve, so a failed
        flush leaves every buffered request intact for retry.

        Returns:
          ``{table name: (batch, dim) reduction}`` per table with results;
          ``{}`` when nothing is buffered.  Row order within a table is
          submission order.
        """
        with self._lock:
            if self._buffered == 0:
                return {}
            out = self.serve({n: q for n, q in self._buffer.items() if q})
            self._buffer = {n: [] for n in self.names}
            self._buffered = 0
            return out

    def close(self) -> None:
        """Closes the front door: later :meth:`submit` calls raise.
        Buffered queries not yet flushed are counted in the stats'
        ``unserved_at_close``.  Idempotent."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self.stats.unserved_at_close = self._buffered

    def __enter__(self) -> "ShardedEmbeddingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- report --

    def report(self) -> Dict[str, object]:
        """Serving + placement accounting.

        Returns a dict with ``tables`` (sorted names), ``plan``
        (:meth:`ShardPlan.memory_summary`), ``serve``
        (:meth:`ShardedServeStats.summary`), ``mode`` (``"emulated"``),
        ``device``, ``image_bytes`` (the shard image stack on the device)
        and ``dispatch_cache`` (the reference's schema, all zero).
        """
        return {
            "tables": self.names,
            "plan": self.plan.memory_summary(),
            "serve": self.stats.summary(),
            "mode": "emulated",
            "device": str(self.device),
            "image_bytes": self.shard_images.numel() * self.shard_images.element_size(),
            "dispatch_cache": dispatch_cache_stats(),
        }
