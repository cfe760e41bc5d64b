"""Embedding-to-crossbar mapping (ReCross §III-A step 3-4 output).

Combines a :class:`~repro_torch.core.grouping.Grouping` with a
:class:`~repro_torch.core.replication.ReplicationPlan` into a concrete physical
layout: which tile (crossbar) holds which rows, where the replicas live,
and the permuted/padded table image that is written to device memory
before inference — the exact analogue of "the embedding table is preloaded
into ReRAM based on this optimized mapping".

The layout is consumed by
  * :mod:`repro_torch.core.reduction`   — torch lookup/reduction through the layout,
  * :mod:`repro_torch.kernels`          — the CUDA crossbar tile kernel,
  * :mod:`repro_torch.dist.shard_plan`  — cross-shard placement of hot tiles.

A NumPy copy of ``repro.core.mapping``; the port keeps its own so that it
never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.grouping import Grouping
from repro_torch.core.replication import ReplicationPlan


@dataclasses.dataclass
class CrossbarLayout:
    """Physical layout of an embedding table over tiles.

    Logical groups ``0..G-1`` map to physical tiles; group ``g`` owns
    ``copies[g]`` physical tiles.  Rows keep their slot within every copy.

    Attributes:
      group_of / slot_of: ``(num_rows,)`` — logical placement of each row.
      copies: ``(G,)`` — physical copies per group.
      tile_base: ``(G,)`` — first physical tile id of each group; the
        copies of group g are tiles ``tile_base[g] .. tile_base[g]+copies[g]-1``.
      tile_rows: rows per tile (group_size, possibly padded).
      num_rows / dim: logical table shape.
    """

    group_of: np.ndarray
    slot_of: np.ndarray
    copies: np.ndarray
    tile_base: np.ndarray
    tile_rows: int
    num_rows: int
    dim: int

    @property
    def num_groups(self) -> int:
        return int(self.copies.shape[0])

    @property
    def num_tiles(self) -> int:
        return int(self.copies.sum())

    @property
    def padded_rows(self) -> int:
        return self.num_tiles * self.tile_rows

    # ---- index plumbing ---------------------------------------------------

    def physical_row(self, row: int, replica: int = 0) -> int:
        """Physical row index of logical ``row`` in its ``replica``-th copy."""
        g = int(self.group_of[row])
        r = replica % int(self.copies[g])
        tile = int(self.tile_base[g]) + r
        return tile * self.tile_rows + int(self.slot_of[row])

    def gather_index_map(self, replica_of_row: np.ndarray | None = None) -> np.ndarray:
        """(num_rows,) logical→physical row map (replica 0 unless given)."""
        g = self.group_of
        base = self.tile_base[g]
        if replica_of_row is not None:
            base = base + (replica_of_row % self.copies[g])
        return (base * self.tile_rows + self.slot_of).astype(np.int32)

    def build_image(self, table: np.ndarray) -> np.ndarray:
        """Materializes the padded, permuted, replicated device image.

        Returns ``(num_tiles * tile_rows, dim)`` — replica tiles hold
        identical data; padding slots are zero (so a stray access
        contributes nothing to a sum, mirroring an unprogrammed ReRAM
        cell at high resistance).  One vectorized scatter: every
        (row, replica) pair's physical row index is computed with
        repeat/cumsum arithmetic, then assigned in a single fancy index.
        """
        if table.shape != (self.num_rows, self.dim):
            raise ValueError(f"table shape {table.shape} != ({self.num_rows},{self.dim})")
        image = np.zeros((self.padded_rows, self.dim), dtype=table.dtype)
        from repro_torch.core.cooccurrence import segment_ranks

        per_row_copies = self.copies[self.group_of].astype(np.int64)
        src = np.repeat(np.arange(self.num_rows, dtype=np.int64), per_row_copies)
        replica = segment_ranks(per_row_copies)
        tile = self.tile_base[self.group_of[src]].astype(np.int64) + replica
        image[tile * self.tile_rows + self.slot_of[src]] = table[src]
        return image

    def tile_of_groups(self) -> np.ndarray:
        """(num_tiles,) group id owning each physical tile."""
        return np.repeat(
            np.arange(self.num_groups, dtype=np.int32), self.copies
        )


def build_layout(
    grouping: Grouping,
    plan: ReplicationPlan,
    dim: int,
    *,
    tile_rows: int | None = None,
) -> CrossbarLayout:
    """Fuses grouping + replication into a physical layout."""
    copies = np.asarray(plan.copies, dtype=np.int32)
    if len(copies) != grouping.num_groups:
        raise ValueError("plan covers a different number of groups")
    tile_base = np.zeros(grouping.num_groups, dtype=np.int64)
    np.cumsum(copies[:-1], out=tile_base[1:])
    return CrossbarLayout(
        group_of=grouping.group_of.copy(),
        slot_of=grouping.slot_of.copy(),
        copies=copies,
        tile_base=tile_base,
        tile_rows=tile_rows or grouping.group_size,
        num_rows=len(grouping.group_of),
        dim=dim,
    )


@dataclasses.dataclass
class ActivationSet:
    """Sparse compiled form of a query batch against a layout.

    The CSR-style contract every consumer (simulator, query compiler,
    dense bitmap scatter) builds on: one entry per *activation* (a
    (query, tile) pair with ≥1 active wordline), sorted by (query, tile),
    plus the flat (query, tile, slot) wordline entries behind them.

    Attributes:
      act_qid / act_tile / act_rows: ``(A,)`` — per-activation query id,
        physical tile id, and popcount, lexicographically sorted by
        (query, tile) (the order ``np.nonzero`` yields on the dense form).
      ent_qid / ent_tile / ent_slot: ``(E,)`` — deduplicated activated
        wordline entries, sorted by (query, tile, slot).
      batch / num_tiles / tile_rows: dense-form dimensions.
    """

    act_qid: np.ndarray
    act_tile: np.ndarray
    act_rows: np.ndarray
    ent_qid: np.ndarray
    ent_tile: np.ndarray
    ent_slot: np.ndarray
    batch: int
    num_tiles: int
    tile_rows: int

    @property
    def num_activations(self) -> int:
        return int(self.act_qid.shape[0])

    def per_query_tiles(self) -> np.ndarray:
        """(batch,) distinct tiles activated by each query."""
        return np.bincount(self.act_qid, minlength=self.batch).astype(np.int64)

    def max_tiles_per_query(self) -> int:
        per_q = self.per_query_tiles()
        return int(per_q.max()) if per_q.size else 0


def _check_ent_key_capacity(layout: CrossbarLayout, batch: int) -> None:
    """Wordline entries pack as ``(qid * num_tiles + tile) * tile_rows +
    slot`` — the product must fit int64 or keys silently alias.  Raised
    before any entry allocation; ``block_queries`` shrinks the packed
    ``qid`` range, which is how huge batches stay under the limit."""
    span = batch * layout.num_tiles * layout.tile_rows
    if span >= 1 << 63:
        raise ValueError(
            f"entry keys would overflow int64: batch={batch} x "
            f"num_tiles={layout.num_tiles} x tile_rows={layout.tile_rows} "
            f">= 2^63; compile with block_queries to bound the packed range"
        )


def compile_activations(
    layout: CrossbarLayout,
    queries: Sequence[Sequence[int]],
    *,
    balance_replicas: bool = True,
    replica_block: int = 1,
    block_queries: int | None = None,
) -> ActivationSet:
    """Query batch → sparse activation set, fully vectorized.

    For each query, rows are bucketed by group; each touched group
    contributes one activated tile (one of its replicas, chosen
    round-robin per group when ``balance_replicas`` — the scheduler's
    replica-balancing step).  The round-robin state is reproduced
    without any Python loop: the replica of the r-th query touching a
    group (in batch order) is ``r % copies[g]``, computed by ranking the
    unique (query, group) touches within each group.

    ``replica_block > 1`` coarsens the round robin to blocks of that many
    consecutive queries: all queries of a block touching a group share one
    replica (the r-th *block* gets ``r % copies[g]``).  Use this when
    compiling for the query-blocked kernel — per-query balancing would
    spread a block's queries over replica tiles of identical data,
    inflating the block's tile union and defeating the DMA amortization.
    Numerics are unaffected either way (replicas hold identical rows).

    ``block_queries`` compiles the batch in chunks of that many
    consecutive queries so the peak intermediate (flattened ids, packed
    touch/entry keys) is O(chunk), not O(batch) — the per-group
    round-robin offset is carried across chunks, so the output is
    bit-identical to the one-shot compile for every chunk size.  Chunk
    boundaries are rounded up to ``replica_block`` multiples so a
    coarsened round-robin unit never straddles a chunk.
    """
    if replica_block < 1:
        raise ValueError("replica_block must be >= 1")
    if block_queries is not None and block_queries < 1:
        raise ValueError("block_queries must be >= 1")
    from repro_torch.core.cooccurrence import flatten_ragged

    arrays = [np.asarray(q, dtype=np.int64).ravel() for q in queries]
    batch = len(arrays)
    empty = np.empty(0, np.int64)
    if block_queries is None or block_queries >= batch:
        _check_ent_key_capacity(layout, max(batch, 1))
        flat, lens, _ = flatten_ragged(arrays)
        if flat.size == 0:
            return ActivationSet(
                act_qid=empty, act_tile=empty, act_rows=empty,
                ent_qid=empty, ent_tile=empty, ent_slot=empty,
                batch=batch, num_tiles=layout.num_tiles,
                tile_rows=layout.tile_rows,
            )
        rr = _rr_state(layout, balance_replicas)
        parts = [_compile_chunk(layout, flat, lens, balance_replicas,
                                replica_block, rr, 0)]
    else:
        # round the chunk up to a replica_block multiple so coarsened
        # round-robin units (replica_block consecutive queries) are whole
        step = -(-block_queries // replica_block) * replica_block
        _check_ent_key_capacity(layout, step)
        rr = _rr_state(layout, balance_replicas)
        parts = []
        for q0 in range(0, batch, step):
            chunk = arrays[q0:q0 + step]
            flat, lens, _ = flatten_ragged(chunk)
            if flat.size == 0:
                continue
            parts.append(_compile_chunk(layout, flat, lens, balance_replicas,
                                        replica_block, rr, q0))
    if not parts:
        return ActivationSet(
            act_qid=empty, act_tile=empty, act_rows=empty,
            ent_qid=empty, ent_tile=empty, ent_slot=empty,
            batch=batch, num_tiles=layout.num_tiles, tile_rows=layout.tile_rows,
        )
    cat = [np.concatenate([p[k] for p in parts]) for k in range(6)]
    return ActivationSet(
        act_qid=cat[0], act_tile=cat[1], act_rows=cat[2],
        ent_qid=cat[3], ent_tile=cat[4], ent_slot=cat[5],
        batch=batch, num_tiles=layout.num_tiles, tile_rows=layout.tile_rows,
    )


def _rr_state(layout: CrossbarLayout, balance_replicas: bool) -> np.ndarray | None:
    """Per-group round-robin touch counters carried across query chunks."""
    if not balance_replicas:
        return None
    return np.zeros(layout.num_groups, dtype=np.int64)


def _compile_chunk(
    layout: CrossbarLayout,
    flat: np.ndarray,
    lens: np.ndarray,
    balance_replicas: bool,
    replica_block: int,
    rr: np.ndarray | None,
    qid_base: int,
) -> tuple[np.ndarray, ...]:
    """Compiles one consecutive query chunk; updates ``rr`` in place.

    ``qid_base`` must be a ``replica_block`` multiple.  Returns the six
    activation/entry arrays with global query ids; within-chunk order is
    (query, tile[, slot]) ascending, so chunks concatenate into the
    globally sorted order the one-shot compile produces.
    """
    from repro_torch.core.cooccurrence import segment_ranks

    chunk_batch = int(lens.size)
    qid = np.repeat(np.arange(chunk_batch, dtype=np.int64), lens)
    group = layout.group_of[flat].astype(np.int64)
    slot = layout.slot_of[flat].astype(np.int64)

    # one tile choice per unique (query, group) touch
    num_groups = np.int64(layout.num_groups)
    touch_key = qid * num_groups + group
    uniq_touch, inv = np.unique(touch_key, return_inverse=True)
    t_qid = uniq_touch // num_groups
    t_group = uniq_touch % num_groups
    if balance_replicas:
        # round-robin unit: a (query, group) touch, or a (block, group)
        # touch when replica_block > 1; qid_base is a replica_block
        # multiple, so local block ids coincide with global ones shifted.
        if replica_block > 1:
            ukey = (t_qid // replica_block) * num_groups + t_group
            units, uinv = np.unique(ukey, return_inverse=True)
            u_group = units % num_groups
        else:
            uinv = None
            u_group = t_group
        # rank of each unit within its group, in batch order: unit keys are
        # sorted by (unit, group), so a stable sort by group preserves batch
        # order inside each group segment — run-local rank is the round robin.
        order = np.argsort(u_group, kind="stable")
        g_sorted = u_group[order]
        run_lengths = np.bincount(
            g_sorted, minlength=layout.num_groups
        ).astype(np.int64)
        rank = np.empty(g_sorted.size, dtype=np.int64)
        rank[order] = segment_ranks(run_lengths)
        rank += rr[u_group]  # carry from earlier chunks
        replica = rank % layout.copies[u_group].astype(np.int64)
        rr += run_lengths
        if uinv is not None:
            replica = replica[uinv]
    else:
        replica = np.zeros(t_qid.size, dtype=np.int64)
    t_tile = layout.tile_base[t_group].astype(np.int64) + replica

    # deduplicated (query, tile, slot) wordline entries
    ent_tile = t_tile[inv]
    tile_rows = np.int64(layout.tile_rows)
    ent_key = (qid * np.int64(layout.num_tiles) + ent_tile) * tile_rows + slot
    ent_uniq = np.unique(ent_key)
    e_slot = ent_uniq % tile_rows
    e_qt = ent_uniq // tile_rows
    e_tile = e_qt % layout.num_tiles
    e_qid = e_qt // layout.num_tiles

    # popcount per activation: ent entries grouped by (qid, tile); the
    # unique (qid, tile) keys come out sorted — matching np.nonzero order
    act_key, act_rows = np.unique(e_qt, return_counts=True)
    base = np.int64(qid_base)
    return (
        (act_key // layout.num_tiles).astype(np.int64) + base,
        (act_key % layout.num_tiles).astype(np.int64),
        act_rows.astype(np.int64),
        e_qid.astype(np.int64) + base,
        e_tile.astype(np.int64),
        e_slot.astype(np.int64),
    )


def query_tile_bitmaps(
    layout: CrossbarLayout,
    queries: Sequence[Sequence[int]],
    *,
    balance_replicas: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Compiles a query batch into dense per-tile wordline bitmaps.

    Vectorized scatter from :func:`compile_activations`.  Prefer the
    sparse :class:`ActivationSet` for large batches — the dense tensor is
    ``batch × num_tiles × tile_rows`` and exists for the kernel-compile
    and diagnostics paths.

    Returns:
      bitmaps: ``(batch, num_tiles, tile_rows)`` uint8 — activation image.
      counts:  ``(batch, num_tiles)`` int32 — popcount per tile (input to
        the dynamic switch).
    """
    acts = compile_activations(layout, queries, balance_replicas=balance_replicas)
    bitmaps = np.zeros((acts.batch, layout.num_tiles, layout.tile_rows), dtype=np.uint8)
    bitmaps[acts.ent_qid, acts.ent_tile, acts.ent_slot] = 1
    counts = np.zeros((acts.batch, layout.num_tiles), dtype=np.int32)
    counts[acts.act_qid, acts.act_tile] = acts.act_rows
    return bitmaps, counts


def _reference_query_tile_bitmaps(
    layout: CrossbarLayout,
    queries: Sequence[Sequence[int]],
    *,
    balance_replicas: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Original per-row Python loop (equivalence oracle for the tests)."""
    batch = len(queries)
    bitmaps = np.zeros((batch, layout.num_tiles, layout.tile_rows), dtype=np.uint8)
    rr = np.zeros(layout.num_groups, dtype=np.int64)  # per-group round robin
    for q_idx, q in enumerate(queries):
        per_group: dict[int, list[int]] = {}
        for row in q:
            per_group.setdefault(int(layout.group_of[row]), []).append(int(row))
        for g, rows in per_group.items():
            if balance_replicas:
                replica = int(rr[g] % layout.copies[g])
                rr[g] += 1
            else:
                replica = 0
            tile = int(layout.tile_base[g]) + replica
            for row in rows:
                bitmaps[q_idx, tile, int(layout.slot_of[row])] = 1
    counts = bitmaps.sum(axis=-1).astype(np.int32)
    return bitmaps, counts
