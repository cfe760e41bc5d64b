"""Runtime validators for the plan/patch/server structural invariants.

The port of ``repro.analysis.invariants``.  The DESIGN.md §5/§6/§9 rules
the serving stack's bit-identity tests pin only by *outcome* are checked
here *structurally*:

  * :func:`validate_plan` — per-shard slot uniqueness, hole/free-slot
    accounting (``local_num_tiles`` = allocated slots, holes allowed),
    the frozen fused tile space (``group_copies`` cumsum layout),
    replicated/sharded/COLD residency consistency, and the fixed
    hot-tier capacity bound.
  * :func:`validate_patch` — a :class:`~repro_torch.dist.replan.PlanPatch`
    checked against the pre-apply plan: class-move preconditions,
    evict/fetch disjointness, DMA/freed-slot accounting (every freed
    slot is exactly a demotion's non-owner slot or an eviction's), and
    a full slot-collision simulation of the apply.
  * :func:`validate_server_state` — a quiesced
    :class:`~repro_torch.serve.sharded.ShardedEmbeddingServer`:
    residency snapshot vs the live plan, host-tier presence of COLD
    rows, drift-tracker dirty-mark accounting, and every packed-key
    encoding (producer ``gseq``, wordline ent keys) within int64
    capacity.

All three raise :class:`InvariantViolation` (an ``AssertionError``
subclass) with a message naming the first violated invariant.  Where a
check is the reference's, its message is the reference's string.

Three server checks differ from the reference's, because the port's
server keeps different state (each is stricter or as strict, none
looser):

  * **Master image.**  The reference keeps the host master image
    ``_fused`` on every server and requires it to cover the tile space.
    The port keeps it only with ``replan=`` (``tiers=`` implies it), so
    a server with ``replan=``, or a plan with any COLD group, must hold
    it; wherever it is present it must cover ``plan.num_tiles``.
  * **Host tables.**  The reference requires a logical host table for
    every name.  The port keeps them only on a CPU async server (the
    watchdog's degraded flush reads them) and serves COLD rows from the
    master image, so the tables are checked wherever they are kept.
  * **Image shape.**  ``shard_images`` is a torch tensor; under
    ``mesh=`` it is this rank's ``(1, depth, tile_rows, dim)`` shard, so
    its leading extent is checked against 1 there and against
    ``plan.num_shards`` otherwise.

Device tensors are read by ``.shape`` only: no ``.item()``, copy or
synchronisation, since the drain hook runs under the server's results
and stamp locks and a device wait there would stall the thread driver.

Opt-in wiring (``RECROSS_VALIDATE=1``, see :func:`validation_enabled`):
``plan_shards`` validates every fresh plan, ``apply_plan_patch``
validates the patch before and the plan after every apply-barrier, and
``drain()`` validates the whole server at full quiescence.  The test
suite defaults the flag on through ``conftest.py``; timed runs leave it
off so their numbers are never validator-skewed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.dist.shard_plan import COLD, ShardPlan


class InvariantViolation(AssertionError):
    """A documented structural invariant (DESIGN.md §5/§6/§9) failed."""


def validation_enabled() -> bool:
    """True when ``RECROSS_VALIDATE`` requests runtime validation.

    Any value other than unset/empty/``"0"`` enables it (the tests'
    ``conftest.py`` sets ``1``; timed runs leave it unset).
    """
    return os.environ.get("RECROSS_VALIDATE", "0") not in ("", "0")


def _fail(msg: str) -> None:
    raise InvariantViolation(msg)


def _tile_group(plan: ShardPlan) -> np.ndarray:
    return np.repeat(
        np.arange(plan.num_groups, dtype=np.int64), plan.group_copies
    )


def validate_plan(plan: ShardPlan) -> None:
    """Checks every structural invariant of a :class:`ShardPlan`.

    Raises:
      InvariantViolation: naming the first violated rule — shape
        mismatches, out-of-range placements, a mutated fused tile
        space, residency/holder inconsistency, duplicate local slots,
        miscounted ``local_num_tiles`` or a busted capacity bound.
    """
    G, T, S = plan.num_groups, plan.num_tiles, plan.num_shards
    if S < 1:
        _fail(f"plan has num_shards={S} (must be >= 1)")
    for name, want in (
        ("shard_of_group", (G,)), ("replicated_group", (G,)),
        ("shard_of_tile", (T,)), ("local_tile_of", (S, T)),
        ("local_num_tiles", (S,)),
    ):
        got = getattr(plan, name).shape
        if got != want:
            _fail(f"{name} has shape {got}, expected {want}")
    if plan.group_load.shape != (G,):
        _fail(
            f"group_load has shape {plan.group_load.shape}, expected ({G},)"
        )
    if not np.all(np.isfinite(plan.group_load)):
        _fail("group_load contains non-finite values")
    if np.any(plan.group_load < 0):
        _fail("group_load contains negative values")

    sog = plan.shard_of_group
    bad = np.nonzero((sog < COLD) | (sog >= S))[0]
    if bad.size:
        _fail(
            f"group {int(bad[0])}: shard_of_group={int(sog[bad[0]])} is "
            f"not a shard id, -1 (replicated) or {COLD} (cold)"
        )
    mism = np.nonzero(plan.replicated_group != (sog == -1))[0]
    if mism.size:
        g = int(mism[0])
        _fail(
            f"group {g}: replicated_group={bool(plan.replicated_group[g])} "
            f"inconsistent with shard_of_group={int(sog[g])}"
        )

    # fused tile space: contiguous cumsum-of-copies layout, frozen —
    # a patch that mutated group_copies (or a tile space whose total
    # no longer matches) is the silent-corruption class §6.2 forbids
    if plan.group_copies is not None:
        copies = plan.group_copies
        if copies.shape != (G,):
            _fail(
                f"group_copies has shape {copies.shape}, expected ({G},)"
            )
        if np.any(copies < 1):
            g = int(np.nonzero(copies < 1)[0][0])
            _fail(f"group {g}: group_copies={int(copies[g])} (must be >= 1)")
        total = int(copies.sum())
        if total != T:
            _fail(
                f"group_copies sums to {total} but the fused tile space "
                f"has {T} tiles — the frozen tile space was mutated"
            )
        tg = _tile_group(plan)
        mism = np.nonzero(plan.shard_of_tile != sog[tg])[0]
        if mism.size:
            t = int(mism[0])
            _fail(
                f"tile {t} (group {int(tg[t])}): shard_of_tile="
                f"{int(plan.shard_of_tile[t])} != shard_of_group="
                f"{int(sog[tg[t]])} — tiles must travel with their group"
            )
    else:
        bad = np.nonzero(
            (plan.shard_of_tile < COLD) | (plan.shard_of_tile >= S)
        )[0]
        if bad.size:
            _fail(
                f"tile {int(bad[0])}: shard_of_tile="
                f"{int(plan.shard_of_tile[bad[0]])} out of range"
            )

    # residency/holders: replicated tiles held everywhere, sharded-once
    # tiles held exactly by their owner, COLD tiles held nowhere (the
    # §9 "cold rows absent from the shard images" half; host-tier
    # presence is the server-state check)
    held = plan.local_tile_of >= 0
    sot = plan.shard_of_tile
    expect = (sot == -1)[None, :] | (
        sot[None, :] == np.arange(S, dtype=sot.dtype)[:, None]
    )
    mism = np.nonzero(held != expect)
    if mism[0].size:
        s, t = int(mism[0][0]), int(mism[1][0])
        owner = int(sot[t])
        kind = (
            "replicated" if owner == -1
            else "cold (host-only)" if owner == COLD
            else f"owned by shard {owner}"
        )
        verb = "does not hold" if expect[s, t] else "holds"
        _fail(
            f"shard {s} {verb} tile {t}, which is {kind} "
            f"(local_tile_of={int(plan.local_tile_of[s, t])})"
        )

    # per-shard slot uniqueness + hole accounting: allocated slots are
    # unique non-negative ints (holes between them are fine — freed
    # slots stop being addressed), local_num_tiles counts exactly the
    # allocated slots, and under a fixed hot tier every slot stays
    # inside the capacity budget
    for s in range(S):
        slots = plan.local_tile_of[s][held[s]]
        uniq, counts = np.unique(slots, return_counts=True)
        if np.any(counts > 1):
            dup = int(uniq[np.argmax(counts > 1)])
            tiles = np.nonzero(held[s] & (plan.local_tile_of[s] == dup))[0]
            _fail(
                f"shard {s}: local slot {dup} assigned to "
                f"{int(counts[counts > 1][0])} tiles "
                f"{tiles.tolist()} — slot uniqueness violated"
            )
        if int(plan.local_num_tiles[s]) != slots.size:
            _fail(
                f"shard {s}: local_num_tiles={int(plan.local_num_tiles[s])} "
                f"but {slots.size} slots are allocated"
            )
        if plan.capacity_tiles is not None and slots.size:
            top = int(slots.max())
            if top >= plan.capacity_tiles:
                _fail(
                    f"shard {s}: slot {top} outside the fixed hot-tier "
                    f"capacity {plan.capacity_tiles}"
                )


def _patch_tiles(plan: ShardPlan, g: int, base: np.ndarray) -> range:
    return range(int(base[g]), int(base[g] + plan.group_copies[g]))


def validate_patch(plan: ShardPlan, patch) -> None:
    """Checks a :class:`~repro_torch.dist.replan.PlanPatch` against the
    pre-apply ``plan``.

    Verifies class-move preconditions (promote from sharded-once
    resident, demote from replicated, evict from sharded-once resident,
    fetch from cold), evict/fetch disjointness, the DMA and freed-slot
    accounting (``len(dma) == Σ_promoted copies·(S-1)``, freed slots
    are exactly the demotions' non-owner slots plus the evictions'
    slots), and a full slot-collision simulation of the apply: no two
    incoming tiles land in one slot, no incoming tile lands in a
    still-occupied slot, every touched slot stays under
    ``new_capacity`` (and under the fixed hot-tier budget when the
    plan has one).

    Raises:
      InvariantViolation: naming the first violated rule.
    """
    G, S = plan.num_groups, plan.num_shards
    load = np.asarray(patch.drifted_load)
    if load.shape != (G,):
        _fail(
            f"patch drifted_load has shape {load.shape}, plan has "
            f"{G} groups"
        )
    if plan.group_copies is None:
        _fail("patch against a plan without group_copies (hand-built plan)")
    base = np.zeros(G, dtype=np.int64)
    np.cumsum(plan.group_copies[:-1], out=base[1:])
    copies = plan.group_copies

    promoted = list(patch.promoted)
    demote_of: Dict[int, int] = {}
    for g, o in patch.demoted:
        if g in demote_of:
            _fail(f"patch demotes group {g} twice")
        demote_of[int(g)] = int(o)
    fetch_of: Dict[int, int] = {}
    for g, s in patch.fetched:
        if g in fetch_of:
            _fail(f"patch fetches group {g} twice")
        fetch_of[int(g)] = int(s)
    evicted = [int(g) for g in patch.evicted]

    for name, ids in (("promoted", promoted), ("evicted", evicted)):
        if len(set(ids)) != len(ids):
            _fail(f"patch {name} list contains duplicate group ids")
    for name, ids in (
        ("promoted", promoted), ("demoted", list(demote_of)),
        ("fetched", list(fetch_of)), ("evicted", evicted),
    ):
        for g in ids:
            if not (0 <= g < G):
                _fail(f"patch {name} group {g} out of range [0, {G})")

    pset, eset, fset = set(promoted), set(evicted), set(fetch_of)
    if pset & set(demote_of):
        g = sorted(pset & set(demote_of))[0]
        _fail(f"patch both promotes and demotes group {g}")
    if eset & fset:
        g = sorted(eset & fset)[0]
        _fail(
            f"patch both evicts and fetches group {g} — evict/fetch "
            f"disjointness violated"
        )
    if pset & eset:
        g = sorted(pset & eset)[0]
        _fail(f"patch both promotes and evicts group {g}")
    if pset & fset:
        g = sorted(pset & fset)[0]
        _fail(f"patch both promotes and fetches group {g} (fetch lands "
              f"sharded-once; promotion is a later patch)")

    # class-move preconditions against the pre-apply plan
    for g in promoted:
        if plan.replicated_group[g]:
            _fail(f"patch promotes group {g} which is already replicated")
        if plan.shard_of_group[g] == COLD:
            _fail(f"patch promotes group {g} which is cold (fetch first)")
    for g, o in demote_of.items():
        if not plan.replicated_group[g]:
            _fail(f"patch demotes group {g} which is not replicated")
        if not (0 <= o < S):
            _fail(f"patch demotes group {g} to shard {o} out of range")
    for g in evicted:
        # a group may be demoted and evicted in ONE patch (demotion
        # lands it sharded-once, eviction then pages it out)
        if plan.replicated_group[g] and g not in demote_of:
            _fail(
                f"patch evicts group {g} which is not sharded-once "
                f"resident (replicated)"
            )
        if plan.shard_of_group[g] == COLD:
            _fail(
                f"patch evicts group {g} which is not sharded-once "
                f"resident (already cold)"
            )
    for g, s in fetch_of.items():
        if plan.shard_of_group[g] != COLD:
            _fail(f"patch fetches group {g} which is already resident")
        if not (0 <= s < S):
            _fail(f"patch fetches group {g} to shard {s} out of range")

    # DMA / freed accounting (DESIGN.md §6.1/§9)
    want = sum(int(copies[g]) * (S - 1) for g in promoted)
    if len(patch.dma) != want:
        _fail(
            f"patch carries {len(patch.dma)} promotion DMAs, promotions "
            f"require {want} (Σ copies · (S-1))"
        )
    want = sum(int(copies[g]) for g in fetch_of)
    if len(patch.fetch_dma) != want:
        _fail(
            f"patch carries {len(patch.fetch_dma)} fetch DMAs, fetches "
            f"require {want} (Σ copies)"
        )
    want = sum(int(copies[g]) for g in evicted)
    if int(patch.evicted_tiles) != want:
        _fail(
            f"patch evicted_tiles={int(patch.evicted_tiles)}, evictions "
            f"free {want} slots (Σ copies)"
        )

    tg = _tile_group(plan)
    for what, dmas, targets, verb in (
        ("DMA", patch.dma, pset, "promoted"),
        ("fetch DMA", patch.fetch_dma, fset, "fetched"),
    ):
        for s, slot, t in dmas:
            if not (0 <= t < plan.num_tiles):
                _fail(f"patch {what} tile {t} out of range")
            if int(tg[t]) not in targets:
                _fail(
                    f"patch {what} targets tile {t} of group {int(tg[t])} "
                    f"which is not {verb}"
                )

    # freed slots must be EXACTLY the demotions' non-owner slots plus
    # the evictions' owner slots (owner after a same-patch demotion)
    expect_freed: Dict[Tuple[int, int], int] = {}
    for g, o in demote_of.items():
        for t in _patch_tiles(plan, g, base):
            for s in range(S):
                if s == o:
                    continue
                slot = int(plan.local_tile_of[s, t])
                if slot < 0:
                    _fail(
                        f"patch demotes group {g} but shard {s} does not "
                        f"hold tile {t}"
                    )
                expect_freed[(s, slot)] = t
    for g in evicted:
        o = demote_of.get(g, int(plan.shard_of_group[g]))
        for t in _patch_tiles(plan, g, base):
            slot = int(plan.local_tile_of[o, t])
            if slot < 0:
                _fail(
                    f"patch evicts group {g} but shard {o} does not hold "
                    f"tile {t}"
                )
            expect_freed[(o, slot)] = t
    got_freed = [(int(s), int(slot)) for s, slot in patch.freed]
    if len(set(got_freed)) != len(got_freed):
        _fail("patch freed list contains duplicate (shard, slot) entries")
    if set(got_freed) != set(expect_freed):
        extra = set(got_freed) - set(expect_freed)
        missing = set(expect_freed) - set(got_freed)
        _fail(
            f"patch freed slots do not match the demotions+evictions: "
            f"unexpected {sorted(extra)[:4]}, missing {sorted(missing)[:4]}"
        )

    # slot-collision simulation of the apply: freed → moved → DMAs
    occ: List[Dict[int, int]] = []
    tile_slot: List[Dict[int, int]] = []
    for s in range(S):
        resident = np.nonzero(plan.local_tile_of[s] >= 0)[0]
        slots = plan.local_tile_of[s, resident].tolist()
        tiles = resident.tolist()
        occ.append(dict(zip(slots, tiles)))
        tile_slot.append(dict(zip(tiles, slots)))
    for (s, slot), t in expect_freed.items():
        del occ[s][slot]
        del tile_slot[s][t]
    for s, t, old, new in patch.moved:
        if tile_slot[s].get(int(t)) != int(old):
            _fail(
                f"patch relocation of tile {t} on shard {s}: expected "
                f"slot {old}, plan has {tile_slot[s].get(int(t))}"
            )
        if int(new) in occ[s]:
            _fail(
                f"patch relocation of tile {t} on shard {s} lands in "
                f"slot {new} still holding tile {occ[s][int(new)]}"
            )
        del occ[s][int(old)]
        occ[s][int(new)] = int(t)
        tile_slot[s][int(t)] = int(new)
    for s, slot, t in list(patch.dma) + list(patch.fetch_dma):
        s, slot, t = int(s), int(slot), int(t)
        if not (0 <= s < S):
            _fail(f"patch DMA shard {s} out of range")
        if slot in occ[s]:
            _fail(
                f"patch DMA of tile {t} to shard {s} slot {slot} collides "
                f"with tile {occ[s][slot]}"
            )
        if t in tile_slot[s]:
            _fail(
                f"patch DMAs tile {t} to shard {s} which already holds it "
                f"at slot {tile_slot[s][t]}"
            )
        if slot >= int(patch.new_capacity):
            _fail(
                f"patch DMA of tile {t} to shard {s} slot {slot} outside "
                f"new_capacity {int(patch.new_capacity)}"
            )
        occ[s][slot] = t
        tile_slot[s][t] = slot
    if plan.capacity_tiles is not None:
        if int(patch.new_capacity) > int(plan.capacity_tiles):
            _fail(
                f"patch new_capacity={int(patch.new_capacity)} exceeds the "
                f"fixed hot-tier capacity {int(plan.capacity_tiles)}"
            )
        for s in range(S):
            if len(occ[s]) > int(plan.capacity_tiles):
                _fail(
                    f"shard {s} would hold {len(occ[s])} tiles after the "
                    f"patch, over the hot-tier capacity "
                    f"{int(plan.capacity_tiles)}"
                )


def validate_server_state(server, *, quiesced: bool = False) -> None:
    """Checks a :class:`~repro_torch.serve.sharded.ShardedEmbeddingServer`.

    Structural rules that must hold at any patch barrier: the live
    plan validates, the device image stack fits the plan (and equals
    the fixed capacity under tiering), the residency snapshot matches
    the plan's resident mask, COLD rows are servable from the host
    master image (and the logical host tables, where the server keeps
    them, cover every table), the drift tracker's arrays are
    consistently shaped with boolean dirty marks, and every packed-key
    encoding still fits int64 — producer ``gseq`` spaces (the
    overflowed-``gseq`` corruption class) and the wordline ent keys at
    the server's batch size.  The module docstring lists where these
    rules differ from the reference's.

    With ``quiesced=True`` (the drain-time wiring) additionally checks
    full quiescence: empty in-flight pipeline, scheduler, host queue
    and completed-results stash.

    Only the producer registry's own lock is taken (stamp → registry
    is the blessed order's last edge, so calling under the drain's
    stamp lock is safe), plus the results lock when not ``quiesced``;
    everything else is read directly — the caller owns the barrier.

    Raises:
      InvariantViolation: naming the first violated rule.
    """
    plan = server.plan
    validate_plan(plan)

    images = server.shard_images.shape
    depth = int(images[1])
    if server.mesh is not None:
        if images[0] != 1:
            _fail(
                f"mesh rank's shard image has {images[0]} shards, a rank "
                f"holds 1"
            )
    elif images[0] != plan.num_shards:
        _fail(
            f"shard image stack has {images[0]} shards, "
            f"plan has {plan.num_shards}"
        )
    if depth < plan.max_local_tiles:
        _fail(
            f"shard image depth {depth} < plan.max_local_tiles "
            f"{plan.max_local_tiles} — allocated slots fall off the image"
        )
    if server._capacity_tiles is not None:
        if depth != int(server._capacity_tiles):
            _fail(
                f"tiered image depth {depth} != fixed capacity "
                f"{int(server._capacity_tiles)}"
            )
        if plan.capacity_tiles != server._capacity_tiles:
            _fail(
                f"plan.capacity_tiles={plan.capacity_tiles} != server "
                f"capacity {server._capacity_tiles}"
            )

    # host tier: every COLD row must be servable host-side — the fused
    # master image covers the whole tile space, and the logical tables,
    # where kept, cover every served name at the row counts submit()
    # validates
    if server._fused is None:
        if server.replan_cfg is not None or plan.cold_groups.size:
            _fail(
                f"host master image missing on a server with replan= or "
                f"{plan.cold_groups.size} cold groups — patches and cold "
                f"rows read it"
            )
    elif server._fused.shape[0] != plan.num_tiles:
        _fail(
            f"host master image has {server._fused.shape[0]} tiles, plan "
            f"has {plan.num_tiles}"
        )
    if server._host_tables is not None:
        for name in server.names:
            tab = server._host_tables.get(name)
            if tab is None:
                _fail(f"host tier missing logical table {name!r}")
            if int(tab.shape[0]) != server._num_rows[name]:
                _fail(
                    f"host table {name!r} has {int(tab.shape[0])} rows, "
                    f"submit() validates against {server._num_rows[name]}"
                )

    # residency snapshot (§9): refreshed only at barriers, must equal
    # the live plan's resident mask at every barrier
    if server._residency is not None:
        snap = server._residency._resident
        if not np.array_equal(snap, plan.resident_group):
            g = int(np.nonzero(snap != plan.resident_group)[0][0])
            _fail(
                f"residency snapshot disagrees with the plan at group "
                f"{g}: snapshot={bool(snap[g])}, "
                f"plan resident={bool(plan.resident_group[g])} — "
                f"refresh happened off-barrier?"
            )

    # drift tracker: consistently shaped, boolean dirty marks, finite
    # non-negative decayed estimate (dirty-mark accounting feeds the
    # scale-invariant candidates= path, DESIGN.md §11)
    tracker = server.tracker
    if tracker is not None:
        if tracker.decayed.shape != (plan.num_groups,):
            _fail(
                f"drift tracker decayed load has shape "
                f"{tracker.decayed.shape}, plan has {plan.num_groups} groups"
            )
        if tracker._dirty.shape != (plan.num_groups,):
            _fail(
                f"drift tracker dirty marks have shape "
                f"{tracker._dirty.shape}, plan has {plan.num_groups} groups"
            )
        if tracker._dirty.dtype != np.bool_:
            _fail(
                f"drift tracker dirty marks have dtype "
                f"{tracker._dirty.dtype}, expected bool"
            )
        if not np.all(np.isfinite(tracker.decayed)):
            _fail("drift tracker decayed load contains non-finite values")
        if np.any(tracker.decayed < 0):
            _fail("drift tracker decayed load contains negative values")
        if tracker.observed_queries < 0 or tracker.observations < 0:
            _fail("drift tracker observation counters went negative")

    # packed-key capacity: producer gseq spaces (§10) — the NEXT stamp
    # of every registered space must still fit int64, and registration
    # must fit the stride
    reg = server._registry
    with reg._lock:
        labels = list(reg._label)
        spaces = [dict(space) for space in reg._next]
    if len(labels) > reg.stride:
        _fail(
            f"{len(labels)} producer spaces registered at stride "
            f"{reg.stride} — pids alias"
        )
    for pid, space in enumerate(spaces):
        for table, local in space.items():
            if local < 0:
                _fail(
                    f"producer space {labels[pid]!r} table {table!r}: "
                    f"negative local seq {local}"
                )
            if local * reg.stride + pid > (1 << 63) - 1:
                _fail(
                    f"producer space {labels[pid]!r} table {table!r}: "
                    f"next local seq {local} at stride {reg.stride} "
                    f"overflows the packed gseq capacity"
                )

    # wordline ent keys (§11): (qid · num_tiles + ent_tile) · tile_rows
    # + slot must fit int64 at the server's flush batch size
    for name, layout in zip(server.names, server.layouts):
        span = (
            int(server.batch_size) * int(layout.num_tiles)
            * int(layout.tile_rows)
        )
        if span > (1 << 63) - 1:
            _fail(
                f"table {name!r}: wordline ent keys overflow int64 at "
                f"batch {server.batch_size} × {layout.num_tiles} tiles × "
                f"{layout.tile_rows} rows"
            )

    # completed-results stash: chunk shapes agree and no pending gseq
    # is duplicated (a duplicate would tear the drain merge); the rows
    # stay on the device and are read by shape only
    with server._results_lock if not quiesced else _NullContext():
        completed = {
            name: list(chunks) for name, chunks in server._completed.items()
        }
    for name, chunks in completed.items():
        if not chunks:
            continue
        seqs = np.concatenate([np.asarray(c[0]) for c in chunks])
        for cseqs, crows in chunks:
            if np.asarray(cseqs).shape[0] != crows.shape[0]:
                _fail(
                    f"completed stash for {name!r}: {len(cseqs)} seqs vs "
                    f"{len(crows)} rows in one chunk"
                )
        uniq = np.unique(seqs)
        if uniq.size != seqs.size:
            _fail(
                f"completed stash for {name!r} holds duplicate sequence "
                f"ids — the drain merge would tear"
            )

    # buffered-count accounting (global mode)
    buffered = sum(len(q) for q in server._buffer.values())
    if buffered != server._buffered:
        _fail(
            f"_buffered={server._buffered} but the buffer holds "
            f"{buffered} queries"
        )

    if quiesced:
        if server._in_flight:
            _fail(
                f"quiesced server still has {len(server._in_flight)} "
                f"in-flight flushes"
            )
        if server.scheduler is not None and server.scheduler.pending_total():
            _fail(
                f"quiesced server still has "
                f"{server.scheduler.pending_total()} scheduled queries"
            )
        if server._host_queue is not None and len(server._host_queue):
            _fail(
                f"quiesced server still has {len(server._host_queue)} "
                f"host-queued queries"
            )
        if any(completed.values()):
            _fail("quiesced server still stashes completed results")


class _NullContext:
    """No-op lock stand-in for callers that already hold the lock."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
