"""Incremental shard-plan patching for serve-time frequency drift.

The port of ``repro.dist.replan`` (DESIGN.md §6), host NumPy like the
rest of the plan.  :func:`repro_torch.dist.shard_plan.plan_shards` places
groups from training-time frequencies; at serve time the observed
distribution drifts (:mod:`repro_torch.serve.drift` tracks it), and the
paper's Eq.-1 wins depend on the *currently hot* groups being the
replicated ones.  Rather than rebuilding the plan and re-copying the
whole stacked shard image, this module computes an **incremental
patch** against the live plan:

  * **promote** — groups whose Eq.-1 log-scaled copy count on the
    drifted load now reaches the shard count move sharded-once →
    replicated-everywhere.  The owner keeps its tiles; every other
    shard receives a copy (``copies[g] × (S-1)`` tile copies).
  * **demote** — replicated groups that cooled below the threshold move
    to sharded-once on the least loaded shard under the drifted
    frequencies (greedy, descending load — the fresh planner's rule).
    Demotion frees ``S-1`` slots and copies **nothing**.
  * everything else **stays put** (placement inertia), which bounds the
    patch at the moved groups' tiles instead of the whole image.

The patch edits only the plan's *placement* arrays; the fused tile
space, the table segments and ``group_copies`` are frozen.  Freed slots
leave holes in a shard's local numbering that a later promotion reuses,
so ``ShardPlan.max_local_tiles`` tracks the highest allocated slot, not
the resident count.

The image half is :func:`repro_torch.kernels.sharded.patch_shard_images`:
only the patch's writes move tile data, never the full image.

**Paging** (DESIGN.md §9): under a ``capacity_tiles`` hot-tier budget a
:class:`PagingPolicy` extends the patch with **fetch** (a cold group pages
into the hot tier — one master-image copy per tile) and **evict** (a
cooled resident group pages out; its slots return to the free-list and
no data moves).  A swap is hysteresis-gated.  Under paging the capacity
is fixed: promotions that would grow the image are deferred, and slack
age-out is skipped.  The server's ``tiers=`` that drives this branch
comes with a later slice of the port; the function is complete here.

With ``RECROSS_VALIDATE`` set, :func:`apply_plan_patch` validates the
patch before and the plan after every apply
(:mod:`repro_torch.analysis.invariants`).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.replication import log_scaled_copies
from repro_torch.dist.shard_plan import COLD, ShardPlan


@dataclasses.dataclass(frozen=True)
class PagingPolicy:
    """Hot-tier paging knobs consumed by :func:`compute_plan_patch`.

    Attributes:
      capacity_tiles: the per-shard hot-tier budget (slots per shard
        image).  Fixed for the lifetime of the server — paging swaps
        within it, never grows it.
      hysteresis: a cold group may displace a resident victim only when
        ``load[in] > hysteresis · load[victim]``.  Values > 1 make the
        reverse swap immediately impossible (it would require
        ``load[victim] > hysteresis² · load[victim]``), which is the
        anti-thrash guarantee.
      max_fetch_tiles: optional cap on tiles paged IN per patch, to
        bound the DMA stall at one flush barrier (None: unbounded).
      min_fetch_load: a cold group pages in only when its decayed load
        exceeds this (0.0: any observed traffic qualifies).
    """

    capacity_tiles: int
    hysteresis: float = 1.5
    max_fetch_tiles: int | None = None
    min_fetch_load: float = 0.0


@dataclasses.dataclass
class PlanPatch:
    """One drift event's incremental edit of a :class:`ShardPlan`.

    Attributes:
      promoted: fused group ids moving sharded-once → replicated.
      demoted: ``(fused group id, new owner shard)`` pairs moving
        replicated → sharded-once.
      dma: ``(shard, local_slot, fused_tile)`` triples — the ONLY tile
        data movement the patch requires (new holders of promoted
        groups).  ``len(dma) == Σ_promoted copies[g] · (S-1)``.
      freed: ``(shard, local_slot)`` slots released by demotions; no
        data movement, the slot just stops being addressed.
      new_capacity: per-shard image depth required after the patch.
        Grows only when promotions exhaust the free slots + slack
        headroom; SHRINKS below the computed-against capacity only when
        slack age-out was requested (``shrink_slack=`` — long demotion
        streaks leave a free-slot tail that would otherwise persist at
        its high-water mark forever).
      moved: ``(shard, fused_tile, old_slot, new_slot)`` resident-tile
        relocations performed by slack age-out: tiles living above the
        shrunk depth compact down into freed holes so the slice loses
        only unaddressed slots.  Each relocation is one tile DMA from
        the host master image; empty unless ``shrink_slack`` was set.
      drifted_load: the ``(G,)`` fused-group load snapshot the patch was
        computed on; becomes the patched plan's ``group_load`` so the
        drift statistic re-anchors to the new placement.
      fetched: ``(fused group id, shard)`` pairs paging cold →
        sharded-once resident (tiered storage only).
      evicted: fused group ids paging sharded-once → cold; their slots
        land on ``freed`` (no data movement — the host master image is
        authoritative, so page-out is free).
      fetch_dma: ``(shard, local_slot, fused_tile)`` triples for the
        paged-in tiles — like ``dma`` but sourced by the paging path,
        kept separate so paged-tile/byte accounting is exact.
      evicted_tiles: Σ copies over ``evicted`` (slot-count the
        evictions return to the free-list).
      deferred: fused group ids whose Eq.-1 target said replicate but
        whose promotion was deferred by the fixed paging budget.  They
        stay sharded-once; callers tracking drift candidates must keep
        them live (their target status can outlast their drift mark).
    """

    promoted: List[int]
    demoted: List[Tuple[int, int]]
    dma: List[Tuple[int, int, int]]
    freed: List[Tuple[int, int]]
    new_capacity: int
    drifted_load: np.ndarray
    moved: List[Tuple[int, int, int, int]] = dataclasses.field(
        default_factory=list
    )
    fetched: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    evicted: List[int] = dataclasses.field(default_factory=list)
    fetch_dma: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list
    )
    evicted_tiles: int = 0
    deferred: List[int] = dataclasses.field(default_factory=list)

    @property
    def num_moved_groups(self) -> int:
        """Groups changing replication class (promoted + demoted)."""
        return len(self.promoted) + len(self.demoted)

    @property
    def num_paged_tiles(self) -> int:
        """Tiles paged across the host↔device boundary: fetches DMA
        data in; evictions only free slots but count as paging events."""
        return len(self.fetch_dma) + self.evicted_tiles

    @property
    def num_moved_tiles(self) -> int:
        """Tiles the patch DMAs for promotions — the acceptance metric
        vs a full rebuild (compaction DMAs are :attr:`num_relocated_tiles`)."""
        return len(self.dma)

    @property
    def num_relocated_tiles(self) -> int:
        """Tiles slack age-out compacts into lower slots (also DMAs)."""
        return len(self.moved)

    def is_noop(self) -> bool:
        """True when drift changed no replication class, no tile
        relocated AND nothing paged (rebase only) — the only patches
        safe to apply without the image update, since they touch no
        device state."""
        return not (self.promoted or self.demoted or self.moved
                    or self.fetched or self.evicted)

    def summary(self) -> dict:
        """Patch size counters for logs/reports."""
        return {
            "promoted_groups": len(self.promoted),
            "demoted_groups": len(self.demoted),
            "moved_tiles": self.num_moved_tiles,
            "relocated_tiles": self.num_relocated_tiles,
            "freed_slots": len(self.freed),
            "new_capacity": self.new_capacity,
            "fetched_groups": len(self.fetched),
            "evicted_groups": len(self.evicted),
            "fetched_tiles": len(self.fetch_dma),
            "evicted_tiles": self.evicted_tiles,
        }


def rescale_load_to_plan(
    load: np.ndarray, plan: ShardPlan, reference_totals
) -> np.ndarray:
    """Rescales each table segment of a load vector to a reference mass.

    Eq. 1's copy count ``1 + floor(log f_g / log f_total · log B)`` is
    **not scale-invariant**: shrinking every frequency by a common
    factor lowers ``log f_g / log f_total`` for every group.  A decayed
    serve-time estimate sits orders of magnitude below the training
    totals the offline plan was computed from, so feeding it to Eq. 1
    raw would systematically under-promote — hot-set rotations would
    demote cooled groups but rarely replicate the newly-hot ones.
    Rescaling each segment to its training-time total compares
    *distributions* at the calibrated magnitude instead.

    Args:
      load: ``(G,)`` fused-group load (e.g. ``DriftTracker.load()``).
      plan: the plan whose table segments define the scaling blocks.
      reference_totals: per-table reference mass, in segment order
        (the server captures ``Σ group_load`` per segment at build).

    Returns:
      A new ``(G,)`` float64 array; segments with zero observed or zero
      reference mass are left unscaled.
    """
    out = np.asarray(load, dtype=np.float64).copy()
    for seg, total in zip(plan.tables, reference_totals):
        gs = slice(seg.group_offset, seg.group_offset + seg.num_groups)
        mass = out[gs].sum()
        if mass > 0.0 and total > 0.0:
            out[gs] *= float(total) / mass
    return out


def _group_tile_base(plan: ShardPlan) -> np.ndarray:
    if plan.group_copies is None:
        raise ValueError(
            "plan has no group_copies — replanning needs a plan built by "
            "plan_shards (not a hand-constructed ShardPlan)"
        )
    base = np.zeros(plan.num_groups, dtype=np.int64)
    np.cumsum(plan.group_copies[:-1], out=base[1:])
    return base


def _eq1_targets(
    plan: ShardPlan,
    load: np.ndarray,
    eq1_batch: int,
    candidates: np.ndarray | None,
) -> np.ndarray:
    """(G,) bool — groups Eq. 1 says to replicate on the drifted load.

    With ``candidates`` only those groups (plus every currently
    replicated group, so demotion checks stay complete) are evaluated;
    everything else reports False.  Exact under the server's drift
    protocol: a group untouched since the last evaluation has a weakly
    *decreasing* rescaled load against a constant segment total, so a
    group that was not an Eq.-1 target then cannot have become one —
    see DESIGN.md §11.
    """
    S = plan.num_shards
    threshold = max(S, 2)
    target = np.zeros(plan.num_groups, dtype=bool)
    if candidates is None:
        for seg in plan.tables:
            gs = slice(seg.group_offset, seg.group_offset + seg.num_groups)
            target[gs] = log_scaled_copies(load[gs], eq1_batch) >= threshold
        return target
    cand = np.union1d(
        np.asarray(candidates, dtype=np.int64),
        np.nonzero(plan.replicated_group)[0],
    )
    if cand.size and (cand[0] < 0 or cand[-1] >= plan.num_groups):
        raise ValueError("candidate group id out of range")
    for seg in plan.tables:
        lo = seg.group_offset
        hi = lo + seg.num_groups
        cs = cand[np.searchsorted(cand, lo):np.searchsorted(cand, hi)]
        if cs.size:
            # subset evaluation at the full segment's normalizing mass
            target[cs] = log_scaled_copies(
                load[cs], eq1_batch, total=float(load[lo:hi].sum())
            ) >= threshold
    return target


def compute_plan_patch(
    plan: ShardPlan,
    drifted_load: np.ndarray,
    *,
    eq1_batch: int,
    capacity: int | None = None,
    shrink_slack: int | None = None,
    paging: PagingPolicy | None = None,
    candidates: np.ndarray | None = None,
) -> PlanPatch:
    """Diffs the live plan against Eq. 1 evaluated on the drifted load.

    Scale-invariant: the work is O(changed groups) plus vectorized
    NumPy over the slots the patch actually touches — per-shard slot
    occupancy is one int array scatter, free slots one ``flatnonzero``,
    and a patch that changes no replication class never materializes
    slot state at all.  At 10M rows (~10⁵ groups) a drift window's
    patch computes in milliseconds; the retained
    :func:`_reference_compute_plan_patch` oracle is the bit-exact
    specification the tests diff against.

    Args:
      plan: the currently-serving :class:`ShardPlan`.
      drifted_load: ``(G,)`` fused-group access load (e.g. the decayed
        estimate from :class:`repro_torch.serve.drift.DriftTracker`).
      eq1_batch: Eq. 1's ``batch`` for the replicate-vs-shard threshold
        (the server passes its ``batch_size_for_eq1``).
      capacity: current per-shard image depth (slots a promotion may
        fill without growing the image); defaults to
        ``plan.max_local_tiles``.
      shrink_slack: when set, age out slack capacity — the patch's
        ``new_capacity`` drops to the highest slot any shard still
        allocates (post-patch) plus this many headroom slots, instead
        of staying at the high-water mark.  The server requests this
        after long demotion streaks so the slot free-list shrinks back
        instead of growing monotonically; never raises capacity above
        what the patch itself requires.  Ignored under ``paging``
        (tiered capacity is fixed).
      paging: a :class:`PagingPolicy` for capacity-bounded plans.  When
        set, the patch additionally pages cold groups in (``fetched`` /
        ``fetch_dma``) and cooled residents out (``evicted``) within
        the fixed ``paging.capacity_tiles`` budget, hysteresis-gated;
        promotions that would exceed the budget are deferred instead of
        growing the image.
      candidates: optional fused group ids whose replication class may
        have changed (the server passes
        :meth:`~repro_torch.serve.drift.DriftTracker.drifted_groups`).  Eq. 1
        is then evaluated only on ``candidates ∪ replicated`` instead
        of all G groups, which is what makes the patch scale-invariant;
        exact whenever every group whose load *rose* since the last
        evaluation is included (see :func:`_eq1_targets`).  ``None``
        scans every group.

    Returns:
      A :class:`PlanPatch`.  Pure host-side computation — no device
      arrays are touched, so it can run while a flush executes on
      device (the double-buffered staging in
      :class:`repro_torch.serve.sharded.ShardedEmbeddingServer`).
    """
    load = np.asarray(drifted_load, dtype=np.float64)
    if load.shape != (plan.num_groups,):
        raise ValueError(
            f"drifted load has shape {load.shape}, plan has "
            f"{plan.num_groups} groups"
        )
    S = plan.num_shards
    tile_base = _group_tile_base(plan)
    copies = plan.group_copies
    if paging is not None:
        capacity = int(paging.capacity_tiles)
    elif capacity is None:
        capacity = plan.max_local_tiles

    target = _eq1_targets(plan, load, eq1_batch, candidates)

    # cold (host-only) groups cannot jump straight to replicated: they
    # must page in first (sharded-once), and may promote a later patch
    promoted = np.nonzero(
        target & ~plan.replicated_group & plan.resident_group
    )[0]
    demote_ids = np.nonzero(~target & plan.replicated_group)[0]

    if (promoted.size == 0 and demote_ids.size == 0
            and paging is None and shrink_slack is None):
        # class-unchanged rebase: no slot state needed at all
        return PlanPatch(
            promoted=[], demoted=[], dma=[], freed=[],
            new_capacity=capacity, drifted_load=load.copy(),
        )

    # drifted load + resident-tile pressure of the placement that stays
    # put; promoted groups leave their owner's tally (their work
    # round-robins after the patch).  bincount accumulates in the same
    # element order np.add.at would, so the float sums are bit-equal.
    stays = plan.shard_of_group >= 0
    stays[promoted] = False
    owner_of_stays = plan.shard_of_group[stays].astype(np.int64)
    shard_load = np.bincount(
        owner_of_stays, weights=load[stays], minlength=S
    ).tolist()
    shard_tiles = np.bincount(
        owner_of_stays, weights=copies[stays].astype(np.float64), minlength=S
    ).astype(np.int64).tolist()

    # demotions: the fresh planner's rule restricted to the moved
    # groups — greedy descending drifted load; loaded groups to the
    # least-loaded shard (tile pressure breaks ties), but the typical
    # demoted group has COOLED to ~zero load, where frequency balance
    # says nothing: those place on the least-TILE-loaded shard, the
    # cold-tail memory balance that is half the point of sharding.
    demoted: List[Tuple[int, int]] = []
    shard_ids = range(S)
    order = demote_ids[np.argsort(-load[demote_ids], kind="stable")]
    for g in order.tolist():
        if load[g] > 0:
            s = int(min(shard_ids,
                        key=lambda i: (shard_load[i], shard_tiles[i], i)))
        else:
            s = int(min(shard_ids, key=lambda i: (shard_tiles[i], i)))
        demoted.append((g, s))
        shard_load[s] += load[g]
        shard_tiles[s] += int(copies[g])

    # slot bookkeeping, vectorized: per-shard occupancy (slot → fused
    # tile, -1 free) built with one nonzero + scatter instead of S
    # Python dicts; demotions free non-owner slots first, promotions
    # then fill the lowest free slot per shard (deterministic), growing
    # the capacity only when a shard has no free slot left
    width = max(capacity, plan.max_local_tiles)
    if promoted.size:
        width += int(copies[promoted].sum())
    occ = np.full((S, width), -1, dtype=np.int64)
    srows, tcols = np.nonzero(plan.local_tile_of >= 0)
    occ[srows, plan.local_tile_of[srows, tcols]] = tcols
    freed: List[Tuple[int, int]] = []
    for g, o in demoted:
        for t in range(int(tile_base[g]), int(tile_base[g] + copies[g])):
            for s in range(S):
                if s == o:
                    continue
                slot = int(plan.local_tile_of[s, t])
                if slot < 0:
                    raise ValueError(
                        f"replicated group {g}: shard {s} does not hold "
                        f"tile {t}"
                    )
                occ[s, slot] = -1
                freed.append((s, slot))
    free = [np.flatnonzero(occ[s, :capacity] < 0).tolist() for s in range(S)]
    grow = [capacity] * S
    dma: List[Tuple[int, int, int]] = []
    dma_index: dict = {}                   # (shard, slot) → index into dma
    kept_promoted: List[int] = []
    deferred: List[int] = []
    for g in promoted.tolist():
        owner = int(plan.shard_of_group[g])
        c = int(copies[g])
        if paging is not None and any(
            len(free[s]) < c for s in range(S) if s != owner
        ):
            # fixed hot-tier budget: a promotion that would grow the
            # image is deferred (the group stays sharded-once; Eq. 1
            # will re-target it once evictions open slots)
            deferred.append(g)
            continue
        kept_promoted.append(g)
        for t in range(int(tile_base[g]), int(tile_base[g] + c)):
            for s in range(S):
                if s == owner:
                    continue
                if free[s]:
                    slot = free[s].pop(0)
                else:
                    slot = grow[s]
                    grow[s] += 1
                occ[s, slot] = t
                dma_index[(s, slot)] = len(dma)
                dma.append((s, slot, t))
    promoted = np.asarray(kept_promoted, dtype=np.int64)

    # ---- paging (tiered storage, DESIGN.md §9): swap the drifted-hot
    # cold groups into the fixed budget, hysteresis-gated ---------------
    fetched: List[Tuple[int, int]] = []
    evicted: List[int] = []
    fetch_dma: List[Tuple[int, int, int]] = []
    evicted_tiles = 0
    if paging is not None:
        # post-patch owner map (promotions → -1, demotions → new owner)
        own = plan.shard_of_group.copy()
        for g, o in demoted:
            own[g] = o
        own[promoted] = -1
        # eviction candidates: sharded-once residents per shard,
        # coldest first (a group fetched THIS patch is not a candidate —
        # within-patch anti-thrash on top of the hysteresis gate).
        # lexsort (ids last ⇒ secondary key) matches the reference's
        # (load, gid) tuple sort per shard.
        res_ids = np.nonzero(own >= 0)[0]
        vorder = np.lexsort((res_ids, load[res_ids], own[res_ids]))
        v_ids = res_ids[vorder]
        v_shard = own[res_ids][vorder]
        vict_g = [v_ids[v_shard == s] for s in range(S)]
        vict_l = [load[v] for v in vict_g]
        vpos = [0] * S                      # consumed prefix per shard
        cold_ids = np.nonzero(own == COLD)[0]
        cold_ids = cold_ids[load[cold_ids] > paging.min_fetch_load]
        cold_order = cold_ids[np.argsort(-load[cold_ids], kind="stable")]
        for g in cold_order.tolist():
            c = int(copies[g])
            if (paging.max_fetch_tiles is not None
                    and len(fetch_dma) + c > paging.max_fetch_tiles):
                break
            fits = [s for s in range(S) if len(free[s]) >= c]
            if fits:
                s = min(fits, key=lambda i: (shard_load[i], shard_tiles[i], i))
            else:
                # pick the shard whose coldest victims free ≥ c slots at
                # the least evicted load, every victim hysteresis-gated
                best = None               # (victim load Σ, shard, victims)
                for cs in range(S):
                    have = len(free[cs])
                    picks: List[int] = []
                    vload = 0.0
                    pos = vpos[cs]
                    while have < c and pos < vict_g[cs].size:
                        lv = float(vict_l[cs][pos])
                        gv = int(vict_g[cs][pos])
                        if load[g] <= paging.hysteresis * lv:
                            break         # not hot enough to displace
                        picks.append(gv)
                        vload += lv
                        have += int(copies[gv])
                        pos += 1
                    if have >= c and (best is None or (vload, cs) < best[:2]):
                        best = (vload, cs, picks, pos)
                if best is None:
                    continue              # nothing evictable for this one
                _, s, picks, pos = best
                vpos[s] = pos
                for gv in picks:
                    o = int(own[gv])
                    for t in range(int(tile_base[gv]),
                                   int(tile_base[gv] + copies[gv])):
                        slot = int(plan.local_tile_of[o, t])
                        if slot < 0:
                            raise ValueError(
                                f"evicting group {gv}: shard {o} does not "
                                f"hold tile {t}"
                            )
                        occ[o, slot] = -1
                        bisect.insort(free[o], slot)
                        freed.append((o, slot))
                    evicted.append(gv)
                    evicted_tiles += int(copies[gv])
                    own[gv] = COLD
                    shard_load[o] -= float(load[gv])
                    shard_tiles[o] -= int(copies[gv])
            for t in range(int(tile_base[g]), int(tile_base[g] + c)):
                slot = free[s].pop(0)
                occ[s, slot] = t
                fetch_dma.append((s, slot, t))
            fetched.append((g, s))
            own[g] = s
            shard_load[s] += float(load[g])
            shard_tiles[s] += c

    new_capacity = max(grow)
    moved: List[Tuple[int, int, int, int]] = []
    if (shrink_slack is not None and paging is None
            and new_capacity <= capacity):
        # slack age-out: compact the stack down to the busiest shard's
        # resident count + requested headroom.  Tiles above the new
        # depth relocate into free holes below it (one master-image DMA
        # each); a promotion landing above it just retargets its DMA.
        # Only legal when nothing grew this patch.
        depth = min(
            capacity,
            int((occ >= 0).sum(axis=1).max()) + int(shrink_slack),
        )
        for s in range(S):
            over = (np.flatnonzero(occ[s, depth:] >= 0) + depth).tolist()
            free_low = np.flatnonzero(occ[s, :depth] < 0).tolist()
            for old in over:
                new = free_low.pop(0)
                t = int(occ[s, old])
                occ[s, old] = -1
                occ[s, new] = t
                idx = dma_index.pop((s, old), None)
                if idx is not None:
                    dma[idx] = (s, new, t)   # incoming tile, not resident
                    dma_index[(s, new)] = idx
                else:
                    moved.append((s, t, old, new))
        new_capacity = depth
    return PlanPatch(
        promoted=promoted.tolist(),
        demoted=demoted,
        dma=dma,
        freed=freed,
        new_capacity=new_capacity,
        drifted_load=load.copy(),
        moved=moved,
        fetched=fetched,
        evicted=evicted,
        fetch_dma=fetch_dma,
        evicted_tiles=evicted_tiles,
        deferred=deferred,
    )


def _reference_compute_plan_patch(
    plan: ShardPlan,
    drifted_load: np.ndarray,
    *,
    eq1_batch: int,
    capacity: int | None = None,
    shrink_slack: int | None = None,
    paging: PagingPolicy | None = None,
) -> PlanPatch:
    """Original dict-of-slots implementation (equivalence oracle).

    Semantically identical to :func:`compute_plan_patch` with
    ``candidates=None``, but builds per-shard ``{slot: tile}`` dicts and
    Python free-slot sets over the whole image — O(S·T) work per call
    regardless of how small the patch is.  Retained as the oracle the
    property tests diff the vectorized implementation against.
    """
    load = np.asarray(drifted_load, dtype=np.float64)
    if load.shape != (plan.num_groups,):
        raise ValueError(
            f"drifted load has shape {load.shape}, plan has "
            f"{plan.num_groups} groups"
        )
    S = plan.num_shards
    tile_base = _group_tile_base(plan)
    copies = plan.group_copies
    if paging is not None:
        capacity = int(paging.capacity_tiles)
    elif capacity is None:
        capacity = plan.max_local_tiles

    # target replicated set: Eq. 1 on the drifted load, per table segment
    # (Eq. 1 normalizes by the table's total frequency)
    target = np.zeros(plan.num_groups, dtype=bool)
    for seg in plan.tables:
        gs = slice(seg.group_offset, seg.group_offset + seg.num_groups)
        target[gs] = log_scaled_copies(load[gs], eq1_batch) >= max(S, 2)

    # cold (host-only) groups cannot jump straight to replicated: they
    # must page in first (sharded-once), and may promote a later patch
    promoted = np.nonzero(
        target & ~plan.replicated_group & plan.resident_group
    )[0]
    demote_ids = np.nonzero(~target & plan.replicated_group)[0]

    # drifted load + resident-tile pressure of the placement that stays
    # put; promoted groups leave their owner's tally (their work
    # round-robins after the patch)
    shard_load = np.zeros(S, dtype=np.float64)
    shard_tiles = np.zeros(S, dtype=np.int64)
    stays = plan.shard_of_group >= 0
    stays[promoted] = False
    np.add.at(shard_load, plan.shard_of_group[stays], load[stays])
    np.add.at(shard_tiles, plan.shard_of_group[stays], copies[stays])

    # demotions: the fresh planner's rule restricted to the moved
    # groups — greedy descending drifted load; loaded groups to the
    # least-loaded shard (tile pressure breaks ties), but the typical
    # demoted group has COOLED to ~zero load, where frequency balance
    # says nothing: those place on the least-TILE-loaded shard, the
    # cold-tail memory balance that is half the point of sharding.
    demoted: List[Tuple[int, int]] = []
    shard_ids = range(S)
    order = demote_ids[np.argsort(-load[demote_ids], kind="stable")]
    for g in order.tolist():
        if load[g] > 0:
            s = int(min(shard_ids,
                        key=lambda i: (shard_load[i], shard_tiles[i], i)))
        else:
            s = int(min(shard_ids, key=lambda i: (shard_tiles[i], i)))
        demoted.append((g, s))
        shard_load[s] += load[g]
        shard_tiles[s] += int(copies[g])

    # slot bookkeeping: demotions free non-owner slots first, promotions
    # then fill the lowest free slot per shard (deterministic), growing
    # the capacity only when a shard has no free slot left
    slot_tile: List[dict] = []
    for s in range(S):
        resident = np.nonzero(plan.local_tile_of[s] >= 0)[0]
        slot_tile.append({
            int(plan.local_tile_of[s, t]): int(t) for t in resident
        })
    freed: List[Tuple[int, int]] = []
    for g, o in demoted:
        for t in range(int(tile_base[g]), int(tile_base[g] + copies[g])):
            for s in range(S):
                if s == o:
                    continue
                slot = int(plan.local_tile_of[s, t])
                if slot < 0:
                    raise ValueError(
                        f"replicated group {g}: shard {s} does not hold "
                        f"tile {t}"
                    )
                del slot_tile[s][slot]
                freed.append((s, slot))
    free = [sorted(set(range(capacity)) - slot_tile[s].keys()) for s in range(S)]
    grow = [capacity] * S
    dma: List[Tuple[int, int, int]] = []
    dma_index: dict = {}                   # (shard, slot) → index into dma
    kept_promoted: List[int] = []
    deferred: List[int] = []
    for g in promoted.tolist():
        owner = int(plan.shard_of_group[g])
        c = int(copies[g])
        if paging is not None and any(
            len(free[s]) < c for s in range(S) if s != owner
        ):
            # fixed hot-tier budget: a promotion that would grow the
            # image is deferred (the group stays sharded-once; Eq. 1
            # will re-target it once evictions open slots)
            deferred.append(g)
            continue
        kept_promoted.append(g)
        for t in range(int(tile_base[g]), int(tile_base[g] + c)):
            for s in range(S):
                if s == owner:
                    continue
                if free[s]:
                    slot = free[s].pop(0)
                else:
                    slot = grow[s]
                    grow[s] += 1
                slot_tile[s][slot] = t
                dma_index[(s, slot)] = len(dma)
                dma.append((s, slot, t))
    promoted = np.asarray(kept_promoted, dtype=np.int64)

    # ---- paging (tiered storage, DESIGN.md §9): swap the drifted-hot
    # cold groups into the fixed budget, hysteresis-gated ---------------
    fetched: List[Tuple[int, int]] = []
    evicted: List[int] = []
    fetch_dma: List[Tuple[int, int, int]] = []
    evicted_tiles = 0
    if paging is not None:
        # post-patch owner map (promotions → -1, demotions → new owner)
        own = plan.shard_of_group.copy()
        for g, o in demoted:
            own[g] = o
        own[promoted] = -1
        # eviction candidates: sharded-once residents per shard,
        # coldest first (a group fetched THIS patch is not a candidate —
        # within-patch anti-thrash on top of the hysteresis gate)
        victims: List[List[Tuple[float, int]]] = [[] for _ in range(S)]
        for g in np.nonzero(own >= 0)[0].tolist():
            victims[int(own[g])].append((float(load[g]), g))
        for s in range(S):
            victims[s].sort()
        vpos = [0] * S                      # consumed prefix per shard
        cold_ids = np.nonzero(own == COLD)[0]
        cold_ids = cold_ids[load[cold_ids] > paging.min_fetch_load]
        cold_order = cold_ids[np.argsort(-load[cold_ids], kind="stable")]
        for g in cold_order.tolist():
            c = int(copies[g])
            if (paging.max_fetch_tiles is not None
                    and len(fetch_dma) + c > paging.max_fetch_tiles):
                break
            fits = [s for s in range(S) if len(free[s]) >= c]
            if fits:
                s = min(fits, key=lambda i: (shard_load[i], shard_tiles[i], i))
            else:
                # pick the shard whose coldest victims free ≥ c slots at
                # the least evicted load, every victim hysteresis-gated
                best = None               # (victim load Σ, shard, victims)
                for cs in range(S):
                    have = len(free[cs])
                    picks: List[int] = []
                    vload = 0.0
                    pos = vpos[cs]
                    while have < c and pos < len(victims[cs]):
                        lv, gv = victims[cs][pos]
                        if load[g] <= paging.hysteresis * lv:
                            break         # not hot enough to displace
                        picks.append(gv)
                        vload += lv
                        have += int(copies[gv])
                        pos += 1
                    if have >= c and (best is None or (vload, cs) < best[:2]):
                        best = (vload, cs, picks, pos)
                if best is None:
                    continue              # nothing evictable for this one
                _, s, picks, pos = best
                vpos[s] = pos
                for gv in picks:
                    o = int(own[gv])
                    for t in range(int(tile_base[gv]),
                                   int(tile_base[gv] + copies[gv])):
                        slot = int(plan.local_tile_of[o, t])
                        if slot < 0:
                            raise ValueError(
                                f"evicting group {gv}: shard {o} does not "
                                f"hold tile {t}"
                            )
                        del slot_tile[o][slot]
                        bisect.insort(free[o], slot)
                        freed.append((o, slot))
                    evicted.append(gv)
                    evicted_tiles += int(copies[gv])
                    own[gv] = COLD
                    shard_load[o] -= float(load[gv])
                    shard_tiles[o] -= int(copies[gv])
            for t in range(int(tile_base[g]), int(tile_base[g] + c)):
                slot = free[s].pop(0)
                slot_tile[s][slot] = t
                fetch_dma.append((s, slot, t))
            fetched.append((g, s))
            own[g] = s
            shard_load[s] += float(load[g])
            shard_tiles[s] += c

    new_capacity = max(grow)
    moved: List[Tuple[int, int, int, int]] = []
    if (shrink_slack is not None and paging is None
            and new_capacity <= capacity):
        # slack age-out: compact the stack down to the busiest shard's
        # resident count + requested headroom.  Tiles above the new
        # depth relocate into free holes below it (one master-image DMA
        # each); a promotion landing above it just retargets its DMA.
        # Only legal when nothing grew this patch.
        target = min(
            capacity, max(len(st) for st in slot_tile) + int(shrink_slack)
        )
        for s in range(S):
            over = sorted(slot for slot in slot_tile[s] if slot >= target)
            free_low = sorted(
                set(range(target)) - set(slot_tile[s])
            )
            for old in over:
                new = free_low.pop(0)
                t = slot_tile[s].pop(old)
                slot_tile[s][new] = t
                idx = dma_index.pop((s, old), None)
                if idx is not None:
                    dma[idx] = (s, new, t)   # incoming tile, not resident
                    dma_index[(s, new)] = idx
                else:
                    moved.append((s, t, old, new))
        new_capacity = target
    return PlanPatch(
        promoted=promoted.tolist(),
        demoted=demoted,
        dma=dma,
        freed=freed,
        new_capacity=new_capacity,
        drifted_load=load.copy(),
        moved=moved,
        fetched=fetched,
        evicted=evicted,
        fetch_dma=fetch_dma,
        evicted_tiles=evicted_tiles,
        deferred=deferred,
    )


def apply_plan_patch(plan: ShardPlan, patch: PlanPatch) -> ShardPlan:
    """Applies a patch to the placement arrays; returns a new plan.

    The input plan is not mutated (the server swaps plans atomically
    between flushes).  Only placement arrays change: the fused tile
    space, table segments and ``group_copies`` carry over by reference.
    """
    # opt-in structural validation at the apply barrier
    # (RECROSS_VALIDATE=1, DESIGN.md §12); lazy import: analysis
    # imports this module's package at its own top level
    from repro_torch.analysis.invariants import (
        validate_patch,
        validate_plan,
        validation_enabled,
    )

    validate = validation_enabled()
    if validate:
        validate_patch(plan, patch)

    S = plan.num_shards
    tile_base = _group_tile_base(plan)
    copies = plan.group_copies
    replicated = plan.replicated_group.copy()
    shard_of_group = plan.shard_of_group.copy()
    shard_of_tile = plan.shard_of_tile.copy()
    local = plan.local_tile_of.copy()
    nloc = plan.local_num_tiles.copy()

    for g, o in patch.demoted:
        if not replicated[g]:
            raise ValueError(f"demoting group {g} which is not replicated")
        replicated[g] = False
        shard_of_group[g] = o
        for t in range(int(tile_base[g]), int(tile_base[g] + copies[g])):
            shard_of_tile[t] = o
            for s in range(S):
                if s != o and local[s, t] >= 0:
                    local[s, t] = -1
                    nloc[s] -= 1
    for g in patch.evicted:
        o = int(shard_of_group[g])
        if replicated[g] or o < 0:
            raise ValueError(
                f"evicting group {g} which is not sharded-once resident"
            )
        shard_of_group[g] = COLD
        for t in range(int(tile_base[g]), int(tile_base[g] + copies[g])):
            if local[o, t] < 0:
                raise ValueError(
                    f"evicting group {g}: shard {o} does not hold tile {t}"
                )
            shard_of_tile[t] = COLD
            local[o, t] = -1
            nloc[o] -= 1
    for g in patch.promoted:
        if replicated[g]:
            raise ValueError(f"promoting group {g} which is already replicated")
        if shard_of_group[g] == COLD:
            raise ValueError(f"promoting group {g} which is cold (fetch first)")
        replicated[g] = True
        shard_of_group[g] = -1
        ts = slice(int(tile_base[g]), int(tile_base[g] + copies[g]))
        shard_of_tile[ts] = -1
    for g, o in patch.fetched:
        if shard_of_group[g] != COLD:
            raise ValueError(f"fetching group {g} which is already resident")
        shard_of_group[g] = o
        ts = slice(int(tile_base[g]), int(tile_base[g] + copies[g]))
        shard_of_tile[ts] = o
    for s, slot, t in list(patch.dma) + list(patch.fetch_dma):
        if local[s, t] >= 0:
            raise ValueError(f"shard {s} already holds fused tile {t}")
        local[s, t] = slot
        nloc[s] += 1
    for s, t, old, new in patch.moved:
        if local[s, t] != old:
            raise ValueError(
                f"relocation of fused tile {t} on shard {s}: expected "
                f"slot {old}, plan has {local[s, t]}"
            )
        local[s, t] = new

    out = ShardPlan(
        num_shards=S,
        tables=plan.tables,
        replicated_group=replicated,
        shard_of_group=shard_of_group,
        shard_of_tile=shard_of_tile,
        local_tile_of=local,
        local_num_tiles=nloc,
        group_load=patch.drifted_load.copy(),
        group_copies=copies,
        capacity_tiles=plan.capacity_tiles,
    )
    if validate:
        validate_plan(out)
    return out
