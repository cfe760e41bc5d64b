"""Shard planner: partition the crossbar image over the ``model`` axis.

This is the placement half of the sharded serving datapath documented in
DESIGN.md §4.  A single device cannot hold the replicated crossbar image
for many DLRM tables at production scale, so the image must shard across
the model mesh axis *without* giving back the per-shard DMA amortization
of the query-blocked kernel.  The planner decides, per group (and per
table — multiple tables fuse into one tile id space):

  * **replicated-everywhere** — hot groups whose Eq.-1 log-scaled copy
    count ``floor(log(freq_g)/log(freq_total) · log(batch))`` reaches
    the shard count (:func:`repro_torch.core.replication.
    shard_replication_sets`) are stored on *every* shard.  Their
    activations never cross shards; ownership round-robins over blocks
    so the hottest work spreads across the mesh.
  * **sharded-once** — every other group lives on exactly one shard
    (all of its intra-shard replica tiles move together, so replica
    balancing keeps working shard-locally).  Assignment is greedy
    frequency-balanced: descending group load, least-loaded shard
    first, ties to the lowest shard id — deterministic.

The plan's unit is the **fused tile space**: table *t*'s physical tiles
occupy ``[tile_offset[t], tile_offset[t] + num_tiles_t)``, so one shard
map, one stacked shard image, and one kernel invocation serve every
table at once.  Consumed by
:func:`repro_torch.core.reduction.shard_block_queries` (per-shard block
compiler) and :mod:`repro_torch.kernels.sharded` (the sharded reduction).

Plans are not immutable at serve time in the JAX package: its
``dist/replan.py`` edits the placement arrays *incrementally* when
serve-time access frequencies drift (DESIGN.md §6).  That module is not
ported yet.

**Tiered storage** (DESIGN.md §9): when ``plan_shards`` is given a
``capacity_tiles`` budget, the shard images become a *hot tier* — a
capacity-bounded cache over the host-resident fused master image.  Only
the hottest groups (by load, greedy while the per-shard budget lasts)
are planned resident; the rest are **cold**: ``shard_of_group`` /
``shard_of_tile`` hold the :data:`COLD` sentinel (-2) and no shard
allocates a local slot.  Cold groups are served by the host gather+sum
fallback and can be paged in later by fetch/evict plan patches.

A NumPy copy of ``repro.dist.shard_plan`` without its opt-in validation
hook (``repro.analysis`` is not ported yet).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.mapping import CrossbarLayout
from repro_torch.core.progress import StageProgress
from repro_torch.core.replication import (
    ReplicationPlan,
    log_scaled_copies,
    shard_replication_sets,
)

# ``shard_of_group`` / ``shard_of_tile`` sentinel for groups outside the
# hot tier (host-resident only).  Distinct from -1 (replicated on every
# shard): -1 tiles are held everywhere, COLD tiles are held nowhere.
COLD = -2


@dataclasses.dataclass
class TableSegment:
    """One table's slice of the fused group/tile id spaces."""

    name: str
    group_offset: int
    tile_offset: int
    num_groups: int
    num_tiles: int
    tile_rows: int

    @property
    def tile_end(self) -> int:
        """One past the segment's last fused tile id."""
        return self.tile_offset + self.num_tiles


@dataclasses.dataclass
class ShardPlan:
    """Placement of every fused group/tile onto ``num_shards`` shards.

    Attributes:
      num_shards: model-parallel degree the plan was built for.
      tables: per-table segments of the fused id spaces, in input order.
      replicated_group: ``(G,)`` bool — True where the group is stored on
        every shard (fused group ids).
      shard_of_group: ``(G,)`` int32 — owning shard, -1 for replicated,
        :data:`COLD` (-2) for groups outside the hot tier (host-only).
      shard_of_tile: ``(T,)`` int32 — owning shard per fused physical
        tile, -1 for replicated (consumed as the ownership rule by the
        block compiler), :data:`COLD` for host-only tiles.
      local_tile_of: ``(num_shards, T)`` int32 — fused tile id → local
        tile id on that shard, -1 where the shard does not hold the tile.
      local_num_tiles: ``(num_shards,)`` — tiles resident per shard
        (sharded-owned + replicated).
      group_load: ``(G,)`` float64 — the load metric the placement was
        balanced for.  After an online replan this is the drifted
        snapshot the patch was computed on.
      group_copies: ``(G,)`` int64 — intra-shard replica tiles per fused
        group (frozen: physical tiles never change at serve time).
        Group ``g``'s fused tiles are the contiguous range starting at
        ``cumsum(group_copies)[g-1]`` — the layout invariant
        :func:`plan_shards` pins.  Consumed by
        the replanner's plan patches.
      capacity_tiles: per-shard hot-tier budget the plan was built under
        (None: unbounded — every group resident, no cold tier).
    """

    num_shards: int
    tables: List[TableSegment]
    replicated_group: np.ndarray
    shard_of_group: np.ndarray
    shard_of_tile: np.ndarray
    local_tile_of: np.ndarray
    local_num_tiles: np.ndarray
    group_load: np.ndarray
    group_copies: np.ndarray | None = None
    capacity_tiles: int | None = None

    @property
    def num_groups(self) -> int:
        """Fused group count ``G`` across all tables."""
        return int(self.replicated_group.shape[0])

    @property
    def num_tiles(self) -> int:
        """Fused physical tile count ``T`` across all tables."""
        return int(self.shard_of_tile.shape[0])

    @property
    def max_local_tiles(self) -> int:
        """Stacked per-shard image depth (highest local tile id + 1).

        For a fresh plan local numbering is dense, so this equals
        ``local_num_tiles.max()``; after incremental patches a shard's
        numbering may contain holes (freed slots), so the depth is the
        highest *allocated* slot, not the resident count.
        """
        if self.local_tile_of.size == 0:
            return 0
        return int(self.local_tile_of.max(initial=-1)) + 1

    @property
    def replicated_tiles(self) -> int:
        """Fused tiles stored on every shard."""
        return int((self.shard_of_tile == -1).sum())

    @property
    def resident_group(self) -> np.ndarray:
        """``(G,)`` bool — True where the group is in the hot tier
        (replicated or sharded-once); False for cold (host-only)."""
        return self.shard_of_group != COLD

    @property
    def cold_groups(self) -> np.ndarray:
        """Fused group ids outside the hot tier (host-resident only)."""
        return np.nonzero(self.shard_of_group == COLD)[0]

    @property
    def cold_tiles(self) -> int:
        """Fused tiles outside the hot tier (host-resident only)."""
        return int((self.shard_of_tile == COLD).sum())

    def shard_tiles(self, shard: int) -> np.ndarray:
        """Fused tile ids resident on ``shard``, in local-tile order."""
        resident = np.nonzero(self.local_tile_of[shard] >= 0)[0]
        order = np.argsort(self.local_tile_of[shard][resident], kind="stable")
        return resident[order].astype(np.int64)

    def build_shard_images(self, fused_image: np.ndarray) -> np.ndarray:
        """Stacks per-shard local images from the fused device image.

        Args:
          fused_image: ``(num_tiles, tile_rows, dim)`` — per-table images
            concatenated on the tile axis (see :func:`build_fused_image`).

        Returns:
          ``(num_shards, max_local_tiles, tile_rows, dim)`` — shard s's
          resident tiles at their local ids; unallocated slots (trailing
          padding, and holes left by replan demotions) are zero, so a
          stray access contributes nothing to a sum (the same contract
          as padding slots inside a tile).
        """
        if fused_image.shape[0] != self.num_tiles:
            raise ValueError(
                f"fused image has {fused_image.shape[0]} tiles, plan has "
                f"{self.num_tiles}"
            )
        tile_rows, dim = fused_image.shape[1], fused_image.shape[2]
        out = np.zeros(
            (self.num_shards, self.max_local_tiles, tile_rows, dim),
            dtype=fused_image.dtype,
        )
        for s in range(self.num_shards):
            tiles = self.shard_tiles(s)
            # scatter to the allocated slots, NOT 0..n-1: a patched
            # plan's local numbering may contain holes
            out[s, self.local_tile_of[s][tiles]] = fused_image[tiles]
        return out

    def memory_summary(self) -> dict:
        """Tile residency accounting (replication overhead of the plan)."""
        cold = self.cold_tiles
        sharded_tiles = self.num_tiles - self.replicated_tiles - cold
        stored = sharded_tiles + self.replicated_tiles * self.num_shards
        return {
            "num_tiles": self.num_tiles,
            "replicated_tiles": self.replicated_tiles,
            "cold_tiles": cold,
            "cold_groups": int((self.shard_of_group == COLD).sum()),
            "capacity_tiles": self.capacity_tiles,
            "resident_tile_fraction":
                (self.num_tiles - cold) / max(self.num_tiles, 1),
            "stored_tiles": stored,
            "storage_ratio": stored / max(self.num_tiles, 1),
            "local_num_tiles": self.local_num_tiles.tolist(),
            "max_local_tiles": self.max_local_tiles,
        }


def _fuse_segments(
    names: Sequence[str], layouts: Sequence[CrossbarLayout]
) -> List[TableSegment]:
    segs: List[TableSegment] = []
    g_off = t_off = 0
    tile_rows = layouts[0].tile_rows
    for name, layout in zip(names, layouts):
        if layout.tile_rows != tile_rows:
            raise ValueError(
                f"table {name!r} tile_rows={layout.tile_rows} != {tile_rows}; "
                "fused serving requires a uniform crossbar height"
            )
        segs.append(TableSegment(
            name=name, group_offset=g_off, tile_offset=t_off,
            num_groups=layout.num_groups, num_tiles=layout.num_tiles,
            tile_rows=tile_rows,
        ))
        g_off += layout.num_groups
        t_off += layout.num_tiles
    return segs


def plan_shards(
    layouts: Sequence[CrossbarLayout],
    plans: Sequence[ReplicationPlan],
    num_shards: int,
    *,
    names: Sequence[str] | None = None,
    group_freqs: Sequence[np.ndarray] | None = None,
    eq1_batch: int | None = None,
    capacity_tiles: int | None = None,
) -> ShardPlan:
    """Builds the shard placement for one or more tables.

    Args:
      layouts: per-table crossbar layouts (uniform ``tile_rows``).
      plans: per-table Eq.-1 replication plans (same order).  Besides the
        replicated-everywhere decision (see ``eq1_batch``), only the
        intra-shard replica *structure* (``copies`` per group) is read —
        physical tiles are frozen once the layout is built.
      names: optional table names for reporting (default ``t0..tN``).
      group_freqs: optional per-table per-group access frequencies used
        as the balancing load; falls back to Eq.-1 copy counts (which are
        log-frequency, so still hotness-ordered).
      eq1_batch: when set (requires ``group_freqs``), the
        replicated-everywhere set is *re-evaluated* from ``group_freqs``
        via Eq. 1's log-scaled copy count at this batch size instead of
        being read off the offline ``plans``.  This is the from-scratch
        reference for online replanning (DESIGN.md §6): passing the
        drifted frequencies here must produce a plan whose served
        outputs the incremental patch path reproduces bit-for-bit.  With
        ``group_freqs`` equal to the training-time group frequencies and
        ``eq1_batch`` equal to the plans' ``batch_size``, the replicated
        set is identical to the default path (assuming the ``log``
        scheme with no area budget).
      capacity_tiles: optional per-shard hot-tier budget (in tiles).
        When set, placement walks groups in descending load and admits
        them while the budget lasts: a replicated group needs
        ``copies[g]`` free slots on *every* shard (else it degrades to
        sharded-once), a sharded-once group needs ``copies[g]`` free on
        some shard (else it is left **cold**: host-resident only,
        served by the gather+sum fallback until a replan patch pages it
        in).  None (the default) keeps the uncapped all-resident
        behavior bit-for-bit.

    Returns:
      A :class:`ShardPlan` over the fused group/tile spaces.
    """
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    if capacity_tiles is not None and capacity_tiles < 1:
        raise ValueError("capacity_tiles must be >= 1 (or None for uncapped)")
    if len(layouts) != len(plans) or not layouts:
        raise ValueError("need one replication plan per layout (>= 1 table)")
    if eq1_batch is not None and group_freqs is None:
        raise ValueError("eq1_batch re-evaluates Eq. 1 and needs group_freqs")
    if names is None:
        names = [f"t{i}" for i in range(len(layouts))]
    segs = _fuse_segments(names, layouts)

    G = sum(s.num_groups for s in segs)
    T = sum(s.num_tiles for s in segs)
    replicated = np.zeros(G, dtype=bool)
    load = np.zeros(G, dtype=np.float64)
    copies = np.zeros(G, dtype=np.int64)
    for i, (seg, layout, plan) in enumerate(zip(segs, layouts, plans)):
        gs = slice(seg.group_offset, seg.group_offset + seg.num_groups)
        # Eq.-1 cross-shard rule: copy count >= shard count → replicate;
        # with eq1_batch the copy count is recomputed from the supplied
        # (possibly drifted) frequencies instead of the offline plan
        if eq1_batch is not None:
            replicated[gs] = log_scaled_copies(
                np.asarray(group_freqs[i], dtype=np.float64), eq1_batch
            ) >= max(num_shards, 2)
        else:
            replicated[gs] = shard_replication_sets(plan, num_shards)
        copies[gs] = layout.copies
        # the fused tile space assumes each group's replica tiles are
        # contiguous in fused-group order (what build_layout emits and
        # build_fused_image concatenates) — pin it rather than trust it
        expect_base = np.zeros(seg.num_groups, dtype=np.int64)
        np.cumsum(layout.copies[:-1], out=expect_base[1:])
        if not np.array_equal(layout.tile_base, expect_base):
            raise ValueError(
                f"table {seg.name!r}: tile_base is not the contiguous "
                "cumsum-of-copies layout the fused tile space requires"
            )
        if group_freqs is not None:
            load[gs] = np.asarray(group_freqs[i], dtype=np.float64)
        else:
            load[gs] = plan.copies.astype(np.float64)

    # greedy frequency-balanced assignment of the sharded groups, in
    # descending load order (ties: fused id order, stable).  Loaded
    # groups go to the least-loaded shard (ties: fewest resident tiles,
    # then lowest id).  The ZERO-load cold tail — which contributes no
    # serving load but most of the image bytes — balances on tile count
    # instead: adding load 0 never moves a load-argmin, so load-first
    # placement would pile the entire cold tail onto one shard and
    # forfeit the memory relief that is half the point of sharding.
    # Cold groups sort last, so they also repair tile imbalance the hot
    # phase left behind.
    #
    # Under a capacity budget the same descending-load walk doubles as
    # the hot-tier admission policy: the hottest groups are admitted
    # until the per-shard budget runs out, everything after goes COLD.
    # Replicated admission charges every shard's budget (uncapped
    # placement deliberately does NOT count replicated tiles in the
    # tie-break totals — that behavior is preserved bit-for-bit).
    # plain Python lists in the sequential walk: per-step numpy scalar
    # indexing/compare dominates at 10⁵+ groups, list ops are ~5× faster
    # and bit-identical (Python floats ARE IEEE doubles)
    shard_of_group = np.full(G, -1, dtype=np.int32)
    shard_load = [0.0] * num_shards
    shard_tiles = [0] * num_shards
    order = np.argsort(-load, kind="stable")
    shard_ids = range(num_shards)
    cap = capacity_tiles
    load_l = load.tolist()
    copies_l = copies.tolist()
    repl_l = replicated.tolist()
    progress = StageProgress("placement", G, unit="groups")
    for done, g in enumerate(order.tolist()):
        if done & 0x3FFF == 0:
            progress.tick(done)
        c = copies_l[g]
        if repl_l[g]:
            if cap is not None:
                if max(shard_tiles) + c <= cap:
                    shard_tiles = [t + c for t in shard_tiles]
                else:
                    # no room on every shard: degrade to sharded-once
                    # (still hot — it gets the next-best residency)
                    replicated[g] = False
                    repl_l[g] = False
            if repl_l[g]:
                continue
        if cap is None:
            fits = shard_ids
        else:
            fits = [i for i in shard_ids if shard_tiles[i] + c <= cap]
            if not fits:
                shard_of_group[g] = COLD
                continue
        lg = load_l[g]
        if lg > 0:
            s = min(fits, key=lambda i: (shard_load[i], shard_tiles[i], i))
        else:
            s = min(fits, key=lambda i: (shard_tiles[i], i))
        shard_of_group[g] = s
        shard_load[s] += lg
        shard_tiles[s] += c
    progress.finish(G)

    # per-tile placement: a group's replica tiles travel with the group
    tile_group = np.repeat(np.arange(G, dtype=np.int64), copies)
    shard_of_tile = shard_of_group[tile_group].astype(np.int32)

    # local tile numbering: resident tiles in ascending fused id order
    local_tile_of = np.full((num_shards, T), -1, dtype=np.int32)
    local_num_tiles = np.zeros(num_shards, dtype=np.int64)
    for s in range(num_shards):
        resident = np.nonzero((shard_of_tile == s) | (shard_of_tile == -1))[0]
        local_tile_of[s, resident] = np.arange(resident.size, dtype=np.int32)
        local_num_tiles[s] = resident.size

    plan = ShardPlan(
        num_shards=num_shards,
        tables=segs,
        replicated_group=replicated,
        shard_of_group=shard_of_group,
        shard_of_tile=shard_of_tile,
        local_tile_of=local_tile_of,
        local_num_tiles=local_num_tiles,
        group_load=load,
        group_copies=copies,
        capacity_tiles=capacity_tiles,
    )
    return plan


def build_fused_image(
    layouts: Sequence[CrossbarLayout], tables: Sequence[np.ndarray]
) -> np.ndarray:
    """Builds the concatenated multi-table device image.

    Args:
      layouts: per-table crossbar layouts, in the same order (and with
        the same uniform ``dim``) as passed to :func:`plan_shards`.
      tables: per-table logical ``(rows, dim)`` arrays.

    Returns:
      ``(Σ num_tiles, tile_rows, dim)`` — each table's permuted,
      replicated image (:meth:`CrossbarLayout.build_image`) reshaped to
      tile-major and concatenated on the tile axis, so fused tile id
      ``tile_offset[t] + k`` indexes table ``t``'s physical tile ``k``.
      This is also the host-resident master copy online replanning DMAs
      moved tiles from (DESIGN.md §6).
    """
    if len(layouts) != len(tables) or not layouts:
        raise ValueError("need one table per layout (>= 1 table)")
    dim = layouts[0].dim
    parts = []
    for layout, table in zip(layouts, tables):
        if layout.dim != dim:
            raise ValueError("fused serving requires a uniform embedding dim")
        parts.append(
            layout.build_image(np.asarray(table))
            .reshape(layout.num_tiles, layout.tile_rows, dim)
        )
    return np.concatenate(parts, axis=0)
