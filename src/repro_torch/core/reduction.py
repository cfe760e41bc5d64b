"""Embedding reduction through a ReCross layout, in PyTorch.

The port of ``repro.core.reduction``.  Given the permuted/replicated
device image produced by :meth:`CrossbarLayout.build_image`, perform the
embedding-bag reduction for a batch of queries.  Three executable paths,
all producing identical values:

  * :func:`reduce_dense_oracle` — direct gather+sum on the *logical* table
    (ground truth; layout-independent).
  * :func:`reduce_via_layout`   — batched torch tiled MAC through the
    physical image with the dynamic READ/MAC switch as ``torch.where``.
  * :func:`repro_torch.kernels.ops.crossbar_reduce` — the CUDA kernel.

Queries arrive in the compiled query format (fixed shapes):

  ``tile_ids``  (batch, max_tiles)            int32, -1 padded
  ``bitmaps``   (batch, max_tiles, tile_rows) activation masks (0/1)

The compile itself is host NumPy; the data classes carry torch tensors
on the device the caller names.  Bitmaps keep the image's dtype (a bf16
image gets bf16 bitmaps); 0/1 values are exact in every float dtype, so
the host work runs on float32 copies.  The server's path,
:func:`shard_block_activations`, builds no dense bitmap on the host: it
sends the ones' flat indices and sets them on the device, in a bitmap
buffer kept zeroed between batches (:class:`ZeroedBitmaps`).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.cooccurrence import segment_ranks
from repro_torch.core.mapping import ActivationSet, CrossbarLayout, compile_activations


@dataclasses.dataclass
class CompiledQueries:
    """Fixed-shape query batch (device tensors)."""

    tile_ids: torch.Tensor   # (batch, max_tiles) int32, -1 = padding
    bitmaps: torch.Tensor    # (batch, max_tiles, tile_rows) same dtype as table
    max_tiles: int

    @property
    def batch(self) -> int:
        return self.tile_ids.shape[0]


@dataclasses.dataclass
class BlockedQueries:
    """Query-blocked compiled batch (device tensors, DESIGN.md §3).

    ``q_block`` consecutive queries share one tile schedule (the union of
    their per-query tile lists, deduplicated): one tile read serves the
    whole block.  The batch is padded up to a q_block multiple; kernel
    output rows beyond :attr:`batch` are padding and should be sliced off.
    """

    tile_ids: torch.Tensor   # (nb, max_tiles) int32, -1 = padding — per block
    bitmaps: torch.Tensor    # (nb, max_tiles, q_block, tile_rows)
    q_block: int
    batch: int               # original (unpadded) query count

    @property
    def num_blocks(self) -> int:
        return self.tile_ids.shape[0]

    @property
    def max_tiles(self) -> int:
        return self.tile_ids.shape[1]


def _host(t: torch.Tensor) -> np.ndarray:
    """Tensor (any device) → host NumPy; bf16 widens to float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _to_device(a: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Host array → tensor on ``device``.  A CUDA target is staged
    through pinned memory and copied with ``non_blocking=True``: a copy
    from pageable memory would make the host wait for every kernel
    already queued on the stream, so compiling flush *n+1* would wait
    for flush *n*.  The caching host allocator keeps the pinned block
    until the copy's stream event completes, and stream order keeps
    every consumer behind the copy.  A dtype change runs on the device
    after the copy (``copy_`` would convert on the host, into pageable
    memory)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        trace.count("h2d_bytes", t.nbytes)
        return t.pin_memory().to(device=device, non_blocking=True).to(dtype=dtype)
    return t.to(device=device, dtype=dtype)


def compile_queries(
    layout: CrossbarLayout,
    queries: Sequence[Sequence[int]],
    *,
    max_tiles: int | None = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    balance_replicas: bool = True,
    replica_block: int = 1,
) -> CompiledQueries:
    """Ragged host queries → fixed-shape tensors on ``device``.

    ``max_tiles`` defaults to the batch's maximum tiles-per-query, rounded
    up to a multiple of 8.  Built directly from the sparse
    :class:`~repro_torch.core.mapping.ActivationSet` with two scatters.
    Pass ``replica_block=q_block`` when the result feeds
    :func:`block_compiled_queries` so replica choice is shared inside
    each block.
    """
    with trace.span("compile.activations"):
        acts = compile_activations(
            layout, queries,
            balance_replicas=balance_replicas, replica_block=replica_block,
        )
    with trace.span("compile.bitmaps"):
        batch = acts.batch
        per_q = acts.per_query_tiles()
        width = int(per_q.max()) if per_q.size else 1
        max_tiles = _padded_width(width, max_tiles, "query")

        tile_ids = np.full((batch, max_tiles), -1, dtype=np.int32)
        bitmaps = np.zeros((batch, max_tiles, layout.tile_rows), dtype=np.float32)
        # slot position of each activation within its query (activations
        # are (query, tile)-sorted, so the run-local rank is the position)
        pos = segment_ranks(per_q)
        tile_ids[acts.act_qid, pos] = acts.act_tile
        # wordline entries inherit their activation's slot position
        ent_pos = np.repeat(pos, acts.act_rows)
        bitmaps[acts.ent_qid, ent_pos, acts.ent_slot] = 1.0
        return CompiledQueries(
            tile_ids=_to_device(tile_ids, device),
            bitmaps=_to_device(bitmaps, device, dtype),
            max_tiles=max_tiles,
        )


def _pad_to_blocks(
    ids: np.ndarray, bms: np.ndarray, q_block: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Zero/-1-pads a flat compiled batch up to a q_block multiple."""
    batch, s_flat = ids.shape
    tile_rows = bms.shape[-1]
    nb = -(-batch // q_block) if batch else 0
    pad = nb * q_block - batch
    if pad:
        ids = np.concatenate([ids, np.full((pad, s_flat), -1, ids.dtype)])
        bms = np.concatenate([bms, np.zeros((pad, s_flat, tile_rows), bms.dtype)])
    return ids, bms, nb


def _check_block_key_capacity(n_outer: int, n_inner: int, what: str) -> None:
    """Packed block keys ``outer * n_inner + inner`` must fit in int64.

    Only reachable with absurd block counts, but wraparound here would
    silently merge unrelated (block, tile) pairs instead of raising.
    """
    if n_outer and n_inner and n_outer > ((1 << 63) - 1) // n_inner:
        raise OverflowError(
            f"{what}: {n_outer} x {n_inner} packed keys overflow int64"
        )


def _padded_width(width: int, max_tiles: int | None, what: str) -> int:
    """Union width → tile-axis allocation: a multiple of 8.

    One definition for every block compiler — the per-shard-grid ≤
    flat-grid invariant relies on both rounding widths identically.
    """
    if max_tiles is None:
        max_tiles = max(8, int(np.ceil(width / 8)) * 8)
    if width > max_tiles:
        raise ValueError(f"{what} touches {width} tiles > max_tiles={max_tiles}")
    return max_tiles


def block_compiled_queries(
    cq: CompiledQueries,
    q_block: int,
    *,
    max_tiles: int | None = None,
    device=None,
) -> BlockedQueries:
    """Flat compiled batch → query-blocked layout for the blocked kernel.

    Each block of ``q_block`` consecutive queries gets the deduplicated
    union of its members' tile lists.  Ragged batches are zero-padded up
    to a block multiple.  Compile ``cq`` with ``replica_block=q_block``.
    The result lands on ``device`` (default: ``cq``'s device).
    """
    if q_block < 1:
        raise ValueError("q_block must be >= 1")
    device = cq.tile_ids.device if device is None else device
    dtype = cq.bitmaps.dtype
    ids, bms, nb = _pad_to_blocks(_host(cq.tile_ids), _host(cq.bitmaps), q_block)
    batch = cq.tile_ids.shape[0]
    tile_rows = bms.shape[-1]

    vq, vs = np.nonzero(ids >= 0)
    vt = ids[vq, vs].astype(np.int64)
    vblk = vq // q_block
    num_tiles = int(vt.max()) + 1 if vt.size else 1
    _check_block_key_capacity(max(nb, 1), num_tiles, "block_compiled_queries")
    key = vblk * np.int64(num_tiles) + vt
    uniq = np.unique(key)
    ub = (uniq // num_tiles).astype(np.int64)
    ut = (uniq % num_tiles).astype(np.int64)
    per_blk = np.bincount(ub, minlength=max(nb, 1))
    width = int(per_blk.max()) if uniq.size else 0
    max_tiles = _padded_width(width, max_tiles, "block")

    blocked_ids = np.full((max(nb, 1), max_tiles), -1, dtype=np.int32)
    pos_u = segment_ranks(per_blk)
    blocked_ids[ub, pos_u] = ut
    blocked_bms = np.zeros(
        (max(nb, 1), max_tiles, q_block, tile_rows), dtype=bms.dtype
    )
    pos_entry = pos_u[np.searchsorted(uniq, key)]
    blocked_bms[vblk, pos_entry, vq % q_block] = bms[vq, vs]
    return BlockedQueries(
        tile_ids=_to_device(blocked_ids, device),
        bitmaps=_to_device(blocked_bms, device, dtype),
        q_block=q_block,
        batch=batch,
    )


@dataclasses.dataclass
class ShardedBlockedQueries:
    """Per-shard query-blocked batch for the sharded kernel (DESIGN.md §4).

    The stacked form of ``P`` shard-local :class:`BlockedQueries`: every
    shard sees the same block axis (so cross-shard partial sums align
    row-for-row) but its own tile schedule — shard-local tile ids,
    shard-local tile unions.  An activation (query, tile) is owned by
    exactly one shard, so summing the shards' kernel outputs reproduces
    the single-device blocked reduction exactly once per activation.

    Built by :func:`shard_block_queries` from a dense fused compile, or,
    on the server's path, by :func:`shard_block_activations` from the
    sparse activation sets, with the bitmaps expanded on their device;
    both give the same fields bit for bit.
    """

    tile_ids: torch.Tensor   # (P, nb, max_tiles) int32 shard-LOCAL ids, -1 pad
    bitmaps: torch.Tensor    # (P, nb, max_tiles, q_block, tile_rows)
    q_block: int
    batch: int               # original (unpadded) query count
    shard_widths: np.ndarray  # (P,) widest per-shard block union, pre-pad
    shards: np.ndarray | None = None  # (P,) global shard ids of the stack
    # (None = all shards in order, the full-flush compile)
    #: (slots, single-entry slots, ones in the other slots), counted only
    #: while tracing is on (:mod:`repro_torch.core.trace`); the dispatch
    #: credits them
    slot_counts: tuple[int, int, int] | None = None

    @property
    def num_shards(self) -> int:
        return self.tile_ids.shape[0]

    @property
    def shard_ids(self) -> np.ndarray:
        """Global shard id of each stacked schedule."""
        if self.shards is not None:
            return self.shards
        return np.arange(self.num_shards, dtype=np.int64)

    @property
    def num_blocks(self) -> int:
        return self.tile_ids.shape[1]

    @property
    def max_tiles(self) -> int:
        return self.tile_ids.shape[2]

    def grid_cells_per_shard(self) -> int:
        """Block × tile-slot cells each shard runs (= nb × padded max_tiles)."""
        return self.num_blocks * self.max_tiles


@dataclasses.dataclass
class FusedActivations:
    """A batch's activations in the fused tile space, on the host: the
    sparse form the server's drift observation reads (one entry per
    (query, tile) activation, in the dense compile's slot order)."""

    tile_ids: np.ndarray  # (A,) int64 fused tile ids
    rows: np.ndarray      # (A,) int64 active wordlines (popcount) of each

    @classmethod
    def of(cls, acts: Sequence[ActivationSet], tile_offsets: Sequence[int]) -> "FusedActivations":
        """Per-table activation sets rebased by their tile offsets."""
        return cls(
            tile_ids=np.concatenate([a.act_tile + int(o) for a, o in zip(acts, tile_offsets)]),
            rows=np.concatenate([a.act_rows for a in acts]),
        )


def _participant_stack(plan, participants) -> tuple[np.ndarray, np.ndarray | None]:
    """The stacked shards of a compile and its ``shards`` field: every
    shard in order (``None``), or the given non-empty unique subset."""
    S = int(plan.num_shards)
    if participants is None:
        return np.arange(S, dtype=np.int64), None
    parts = np.asarray(list(participants), dtype=np.int64)
    if parts.size == 0 or parts.size != np.unique(parts).size:
        raise ValueError(f"participants must be non-empty unique ids, got {parts}")
    if parts.min() < 0 or parts.max() >= S:
        raise ValueError(f"participants {parts} out of range for {S} shards")
    return parts, parts


@dataclasses.dataclass
class _ShardUnion:
    """Each activation's owner and slot in the per-shard blocked grid."""

    pos_own: np.ndarray      # (A,) stack position of the owning shard
    slot: np.ndarray         # (A,) index into the union
    pos_entry: np.ndarray    # (A,) tile slot within its (shard, block)
    blocked_ids: np.ndarray  # (P, nb_safe, max_tiles) int32 local ids, -1 pad
    widths: np.ndarray       # (P,) widest block union, pre-pad
    num_slots: int           # non-padding (shard, block, tile) slots


def _shard_union(plan, parts, vt, vblk, nb_safe: int, max_tiles: int | None) -> _ShardUnion:
    """Activations ``(fused tile vt, block vblk)`` → owner shards and the
    per-(shard, block) deduplicated tile unions.

    Replicated-everywhere tiles go round-robin by block over ``parts``;
    a cold (host-tier) tile, a tile owned outside ``parts`` or one its
    owner does not hold raises ``ValueError``.
    """
    S, P = int(plan.num_shards), int(parts.size)
    own = np.asarray(plan.shard_of_tile)[vt].astype(np.int64)
    # -2 is the plan's COLD sentinel (host-tier tiles, held by no shard)
    if (own == -2).any():
        raise ValueError(
            "batch activates cold (host-tier) tiles; cold queries must "
            "take the host gather+sum path, not the crossbar kernels"
        )
    # replicated-everywhere tiles: block-level round robin over the
    # participating shards
    own = np.where(own < 0, parts[vblk % P], own)
    # global shard id → stack position
    part_pos = np.full(S, -1, dtype=np.int64)
    part_pos[parts] = np.arange(P, dtype=np.int64)
    pos_own = part_pos[own]
    if pos_own.size and pos_own.min() < 0:
        missing = np.unique(own[pos_own < 0]).tolist()
        raise ValueError(
            f"batch activates tiles owned by non-participating shards "
            f"{missing}; participants={parts.tolist()}"
        )
    lt = np.asarray(plan.local_tile_of)[own, vt].astype(np.int64)
    if lt.size and lt.min() < 0:
        raise ValueError("plan does not hold an activated tile on its owner")

    Lmax = max(int(plan.max_local_tiles), 1)
    _check_block_key_capacity(P * nb_safe, Lmax, "shard_block_queries")
    key = (pos_own * nb_safe + vblk) * Lmax + lt
    uniq = np.unique(key)
    usb = uniq // Lmax
    ult = (uniq % Lmax).astype(np.int64)
    us = (usb // nb_safe).astype(np.int64)
    ub = (usb % nb_safe).astype(np.int64)
    per_sb = np.bincount(usb, minlength=P * nb_safe)
    width = int(per_sb.max()) if uniq.size else 0
    max_tiles = _padded_width(width, max_tiles, "shard block")

    blocked_ids = np.full((P, nb_safe, max_tiles), -1, dtype=np.int32)
    pos_u = segment_ranks(per_sb)
    blocked_ids[us, ub, pos_u] = ult
    slot = np.searchsorted(uniq, key)
    widths = per_sb.reshape(P, nb_safe).max(axis=1) if uniq.size else np.zeros(P, np.int64)
    return _ShardUnion(pos_own=pos_own, slot=slot, pos_entry=pos_u[slot],
                       blocked_ids=blocked_ids, widths=widths.astype(np.int64),
                       num_slots=int(uniq.size))


def _slot_counts(union: _ShardUnion, popcounts: np.ndarray) -> tuple[int, int, int]:
    """(slots, single-entry slots, ones in the other slots): the kernel's
    READ rule, at most one nonzero entry in the slot, from each
    activation's popcount, and the ones that the MAC slots sum."""
    held = np.bincount(union.slot, weights=popcounts, minlength=union.num_slots)
    return union.num_slots, int((held <= 1).sum()), int(held[held > 1].sum())


def shard_block_queries(
    cq: CompiledQueries,
    plan,
    q_block: int,
    *,
    max_tiles: int | None = None,
    participants: Sequence[int] | None = None,
    device=None,
) -> ShardedBlockedQueries:
    """Flat compiled batch → per-shard blocked layout for ``plan``.

    ``plan`` is a :class:`repro_torch.dist.shard_plan.ShardPlan`
    (duck-typed: only ``num_shards`` / ``shard_of_tile`` /
    ``local_tile_of`` / ``max_local_tiles`` are read).  ``cq.tile_ids``
    must be in the plan's fused tile space — offset per-table compiles
    with :func:`offset_compiled_queries` first.  Compile ``cq`` with
    ``replica_block=q_block``.

    ``participants`` restricts the compile to a shard subset: the stacked
    schedules cover only those shards (in the given order), and
    replicated-everywhere tiles round-robin over the participants.  Every
    sharded-once tile the batch activates must be owned by a participant.
    The result lands on ``device`` (default: ``cq``'s device).
    :func:`shard_block_activations` builds the same batch from the
    sparse activation sets, with no dense host bitmap.
    """
    if q_block < 1:
        raise ValueError("q_block must be >= 1")
    device = cq.tile_ids.device if device is None else device
    dtype = cq.bitmaps.dtype
    parts, shards_field = _participant_stack(plan, participants)
    with trace.span("compile.shard_block"):
        P = int(parts.size)
        ids, bms, nb = _pad_to_blocks(_host(cq.tile_ids), _host(cq.bitmaps), q_block)
        batch = cq.tile_ids.shape[0]
        tile_rows = bms.shape[-1]
        nb_safe = max(nb, 1)

        vq, vs = np.nonzero(ids >= 0)
        vt = ids[vq, vs].astype(np.int64)
        vblk = vq // q_block
        union = _shard_union(plan, parts, vt, vblk, nb_safe, max_tiles)
        blocked_bms = np.zeros(
            (P, *union.blocked_ids.shape[1:], q_block, tile_rows), dtype=bms.dtype
        )
        entries = bms[vq, vs]
        blocked_bms[union.pos_own, vblk, union.pos_entry, vq % q_block] = entries
        slot_counts = None
        if trace.enabled():
            # a 0/1 mask's row sum is its count of nonzeros
            slot_counts = _slot_counts(union, entries @ np.ones(tile_rows, np.float32))
    with trace.span("compile.upload"):
        tile_ids = _to_device(union.blocked_ids, device)
        bitmaps = _to_device(blocked_bms, device, dtype)
    return ShardedBlockedQueries(
        tile_ids=tile_ids,
        bitmaps=bitmaps,
        q_block=q_block,
        batch=batch,
        shard_widths=union.widths,
        shards=shards_field,
        slot_counts=slot_counts,
    )


class ZeroedBitmaps:
    """A flat bitmap buffer kept zeroed between batches, so that a batch's
    ``(P, nb, max_tiles, q_block, tile_rows)`` bitmap costs the setting of
    its ones and not a zero fill of the whole grid just ahead of the
    kernel that reads it.

    :meth:`take` clears the previous batch's ones by the same indices,
    then sets this batch's, both on the current stream: the previous
    batch's kernels were queued there before this batch was compiled, so
    they read their bitmap before it is cleared.  A bitmap is a view of
    the buffer, valid until the next :meth:`take`.  One buffer serves one
    stream and one batch compiled and dispatched at a time, as the server
    compiles and dispatches its batches.  The buffer grows to the largest
    bitmap it has held; a new dtype or device starts a new one.
    """

    def __init__(self) -> None:
        self._flat: torch.Tensor | None = None
        self._ones: torch.Tensor | None = None

    def take(self, shape: tuple[int, ...], ones: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
        """A ``shape`` bitmap of ``dtype``, on ``ones``' device, that is 1
        at the flat int64 indices ``ones`` and 0 elsewhere."""
        numel = int(np.prod(shape, dtype=np.int64))
        flat = self._flat
        if (flat is None or flat.numel() < numel or flat.dtype != dtype
                or flat.device != ones.device):
            flat = self._flat = torch.zeros(numel, dtype=dtype, device=ones.device)
        elif self._ones is not None:
            flat.index_fill_(0, self._ones, 0)
        flat.index_fill_(0, ones, 1)
        self._ones = ones
        return flat[:numel].view(shape)


def _flat_index_dtype(numel: int) -> np.dtype:
    """The flat indices of a bitmap of ``numel`` elements: int32 below
    2**31 elements, else int64."""
    return np.dtype(np.int64 if numel >= 1 << 31 else np.int32)


def shard_block_activations(
    acts: Sequence[ActivationSet],
    tile_offsets: Sequence[int],
    plan,
    q_block: int,
    *,
    max_tiles: int | None = None,
    participants: Sequence[int] | None = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
    fused: FusedActivations | None = None,
    bitmaps: ZeroedBitmaps | None = None,
) -> tuple[ShardedBlockedQueries, list[tuple[int, int]]]:
    """Per-table activation sets → per-shard blocked batch for ``plan``,
    with no dense bitmap on the host.

    ``acts[t]`` is table ``t``'s :func:`~repro_torch.core.mapping.
    compile_activations` with ``replica_block=q_block``, and
    ``tile_offsets[t]`` its first tile in the plan's fused tile space.
    The result equals, field by field and bit for bit, that of
    :func:`compile_queries` → :func:`offset_compiled_queries` →
    :func:`concat_compiled_queries` → :func:`shard_block_queries` on the
    same queries, and so do the per-table ``(row_start, batch)`` spans
    returned beside it; ``participants`` and the errors are
    :func:`shard_block_queries`'.

    Each table's query ids are rebased to its row start (tables padded to
    ``q_block`` multiples) and its tile ids by its offset; the union and
    slot ranks are :func:`shard_block_queries`' own.  Only the
    ``(P, nb, max_tiles)`` tile ids and each wordline entry's flat index
    into the ``(P, nb, max_tiles, q_block, tile_rows)`` bitmap cross to
    ``device``, in one copy; there the ones are set by index, on the
    current stream, in a bitmap of ``dtype`` taken from ``bitmaps`` (a
    buffer kept zeroed between batches) or, without one, zeroed anew.
    ``fused`` is ``FusedActivations.of(acts, tile_offsets)`` where the
    caller has built it already.
    """
    if q_block < 1:
        raise ValueError("q_block must be >= 1")
    if not acts or len(acts) != len(tile_offsets):
        raise ValueError("need one tile offset for each of at least one activation set")
    tile_rows = acts[0].tile_rows
    if any(a.tile_rows != tile_rows for a in acts):
        raise ValueError("activation sets of one batch must share tile_rows")
    parts, shards_field = _participant_stack(plan, participants)
    with trace.span("compile.shard_block"):
        spans, starts, row = [], [], 0
        for a in acts:
            spans.append((row, a.batch))
            starts.append(row)
            row += -(-a.batch // q_block) * q_block
        vq = np.concatenate([a.act_qid + r for a, r in zip(acts, starts)])
        if fused is None:
            fused = FusedActivations.of(acts, tile_offsets)
        vt, popcounts = fused.tile_ids, fused.rows
        ent_slot = np.concatenate([a.ent_slot for a in acts])
        nb_safe = max(row // q_block, 1)
        vblk = vq // q_block
        union = _shard_union(plan, parts, vt, vblk, nb_safe, max_tiles)
        shape = (*union.blocked_ids.shape, q_block, tile_rows)
        # each activation's first element, then its wordline entries
        base = ((((union.pos_own * nb_safe + vblk) * shape[2] + union.pos_entry)
                 * q_block + vq % q_block) * tile_rows)
        flat = np.repeat(base, popcounts) + ent_slot
        slot_counts = _slot_counts(union, popcounts) if trace.enabled() else None
    with trace.span("compile.upload"):
        index = _flat_index_dtype(int(np.prod(shape, dtype=np.int64)))
        n_ids = union.blocked_ids.size
        packed = _to_device(
            np.concatenate([union.blocked_ids.ravel().astype(index), flat.astype(index)]),
            device,
        )
        tile_ids = packed[:n_ids].view(shape[:3]).to(torch.int32)
        bms = (bitmaps or ZeroedBitmaps()).take(shape, packed[n_ids:].long(), dtype)
        if torch.device(device).type == "cuda":
            trace.count("expand_entries", flat.size)
    return ShardedBlockedQueries(
        tile_ids=tile_ids,
        bitmaps=bms,
        q_block=q_block,
        batch=row,
        shard_widths=union.widths,
        shards=shards_field,
        slot_counts=slot_counts,
    ), spans


class BlockUnionTracker:
    """Incremental block-union fill accounting for one pending stream.

    The port of ``repro.core.reduction.BlockUnionTracker`` (host
    bookkeeping).  The flush scheduler (DESIGN.md §7) needs to know, as
    queries accumulate on a flush home — one shard, or a frozen owner set
    of shards — how large that home's kernel grid would be if it flushed
    *now* — without compiling anything.  With ``replica_block=q_block``
    every block resolves each activated group to exactly one replica
    tile, so a block's union width equals the number of distinct groups
    its members touch; this tracker maintains exactly that, one ``set``
    union per in-progress block:

      * :attr:`fill` — Σ union widths over all pending blocks (the raw
        tile-DMA count of a flush-now);
      * :meth:`grid_cells` — ``nb × padded max width``, the same
        padded accounting as :func:`shard_block_queries`.

    ``add`` takes the query's distinct activated *group* ids (host-side
    routing already computes them); O(groups-per-query) per call.
    """

    def __init__(self, q_block: int):
        if q_block < 1:
            raise ValueError("q_block must be >= 1")
        self.q_block = q_block
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._filled = 0          # Σ union widths of completed blocks
        self._max_width = 0
        self._block: set = set()  # current partial block's union

    def add(self, groups) -> None:
        """Appends one query (its distinct activated group ids)."""
        if self._n and self._n % self.q_block == 0:
            self._filled += len(self._block)
            self._max_width = max(self._max_width, len(self._block))
            self._block = set()
        self._block.update(int(g) for g in groups)
        self._n += 1

    @property
    def pending(self) -> int:
        """Queries added since the last reset."""
        return self._n

    @property
    def fill(self) -> int:
        """Σ block-union widths of the pending stream (tile DMA count)."""
        return self._filled + len(self._block)

    def grid_cells(self) -> int:
        """Kernel grid cells of a flush-now (nb × padded width)."""
        if self._n == 0:
            return 0
        nb = -(-self._n // self.q_block)
        width = max(self._max_width, len(self._block))
        return nb * _padded_width(width, None, "pending block")


def fused_group_loads(
    cq: CompiledQueries, tile_group: np.ndarray, num_groups: int
) -> np.ndarray:
    """Per-fused-group active-row counts of a compiled batch.

    The serve-time observation feeding drift tracking (DESIGN.md §6),
    read off the batch compiled for the kernel anyway: each valid
    (query, tile) slot adds its wordline popcount to the tile's group, so
    a query touching *k* rows of a group counts *k* — the per-row
    semantics the shard plan's ``group_load`` was built from.  All
    replicas of a group map to the same group id.

    The popcount is exact in every bitmap dtype: it is summed in float64.
    The reference sums in the bitmaps' own dtype, which in bf16 stops
    counting at 256 (1,024 ones sum to 256), so for a bf16 server with
    ``tile_rows > 256`` it undercounts a slot with more than 256 active
    rows; this port does not.

    Args:
      cq: a compiled batch in the *fused* tile space, on the CPU (the
        server passes its host compile, so the observation never waits
        for the card).
      tile_group: ``(num_tiles,)`` fused tile id → fused group id
        (``repeat(arange(G), group_copies)``).
      num_groups: fused group count G.

    Returns:
      ``(G,)`` float64 active-row counts.
    """
    ids = cq.tile_ids
    valid = ids >= 0
    if not bool(valid.any()):
        return np.zeros(num_groups, dtype=np.float64)
    groups = np.asarray(tile_group)[ids[valid].numpy().astype(np.int64)]
    rows = cq.bitmaps[valid].sum(dim=-1, dtype=torch.float64).numpy()
    return np.bincount(groups, weights=rows, minlength=num_groups).astype(np.float64)


def activation_group_loads(
    acts: FusedActivations, tile_group: np.ndarray, num_groups: int
) -> np.ndarray:
    """:func:`fused_group_loads` of the sparse form: equal to it on the
    dense compile of the same batch, exactly (popcounts are integers).

    Returns:
      ``(G,)`` float64 active-row counts.
    """
    groups = np.asarray(tile_group)[acts.tile_ids]
    return np.bincount(groups, weights=acts.rows, minlength=num_groups).astype(np.float64)


def offset_compiled_queries(cq: CompiledQueries, tile_offset: int) -> CompiledQueries:
    """Rebases a per-table compile into the fused multi-table tile space."""
    ids = cq.tile_ids
    return CompiledQueries(
        tile_ids=torch.where(ids >= 0, ids + tile_offset, ids),
        bitmaps=cq.bitmaps,
        max_tiles=cq.max_tiles,
    )


def concat_compiled_queries(
    cqs: Sequence[CompiledQueries], q_block: int
) -> tuple[CompiledQueries, list[tuple[int, int]]]:
    """Stacks per-table compiled batches for one fused kernel invocation.

    Each table's batch is padded up to a ``q_block`` multiple (so blocks
    never span tables) and all are padded to a common tile width, then
    concatenated on the query axis (on the inputs' device).

    Returns:
      (fused CompiledQueries, per-table ``(row_start, batch)`` spans into
      the fused — and therefore into the kernel output — row space).
    """
    if q_block < 1:
        raise ValueError("q_block must be >= 1")
    if not cqs:
        raise ValueError("need at least one compiled batch")
    with trace.span("compile.concat"):
        width = max(cq.max_tiles for cq in cqs)
        ids_parts, bms_parts, spans = [], [], []
        row = 0
        for cq in cqs:
            ids, bms = cq.tile_ids, cq.bitmaps
            batch, s_flat = ids.shape
            rows = -(-batch // q_block) * q_block if batch else 0
            tile_rows = bms.shape[-1]
            pid = ids.new_full((rows, width), -1)
            pbm = bms.new_zeros((rows, width, tile_rows))
            pid[:batch, :s_flat] = ids
            pbm[:batch, :s_flat] = bms
            ids_parts.append(pid)
            bms_parts.append(pbm)
            spans.append((row, batch))
            row += rows
        fused = CompiledQueries(
            tile_ids=torch.cat(ids_parts),
            bitmaps=torch.cat(bms_parts),
            max_tiles=width,
        )
    return fused, spans


def reduce_dense_oracle(
    table: torch.Tensor, queries: Sequence[Sequence[int]]
) -> torch.Tensor:
    """Ground-truth gather+sum on the logical table (host-ragged input).

    Each query's row ids are deduplicated first, as the layout compile
    does: a row repeated in one query is summed once.
    """
    out = []
    for q in queries:
        ids = torch.tensor(
            sorted(set(int(i) for i in q)), dtype=torch.int64, device=table.device
        )
        out.append(table[ids].sum(dim=0) if len(q) else table.new_zeros(table.shape[-1]))
    return torch.stack(out)


def reduce_via_layout(
    image: torch.Tensor,      # (num_tiles * tile_rows, dim) physical image
    tile_ids: torch.Tensor,   # (batch, max_tiles)
    bitmaps: torch.Tensor,    # (batch, max_tiles, tile_rows)
    *,
    tile_rows: int,
    dynamic_switch: bool = True,
) -> torch.Tensor:
    """Batched torch tiled MAC through the physical image.

    Per (query, slot): fetch the tile, then either
      * READ path  (popcount ≤ 1): select the single active row, or
      * MAC path: ``bitmap @ tile``.
    Padding slots (tile_id == -1) contribute 0.  Works in the image dtype,
    as the JAX twin does.
    """
    num_tiles = image.shape[0] // tile_rows
    dim = image.shape[-1]
    tiles3 = image.reshape(num_tiles, tile_rows, dim)
    bms = bitmaps.to(image.dtype)
    tiles = tiles3[tile_ids.long().clamp(0, num_tiles - 1)]      # (B, S, R, D)
    out = torch.einsum("bsr,bsrd->bsd", bms, tiles)
    if dynamic_switch:
        count = bms.sum(dim=-1)                                   # (B, S)
        row = bms.argmax(dim=-1)                                  # first max
        read = torch.gather(
            tiles, 2, row[..., None, None].expand(-1, -1, 1, dim)
        )[:, :, 0] * (count > 0)[..., None]
        out = torch.where((count <= 1)[..., None], read, out)
    out = out * (tile_ids >= 0)[..., None]
    return out.sum(dim=1)


def reduction_flops(bitmaps, dim: int, dynamic_switch: bool) -> int:
    """FLOPs of the layout reduction (for benchmark reporting).

    ``bitmaps`` is the flat ``(batch, max_tiles, tile_rows)`` or blocked
    ``(nb, max_tiles, q_block, tile_rows)`` mask, as a NumPy array or a
    tensor on any device.  A MAC tile (popcount > 1 with the dynamic
    switch, > 0 without) costs ``2 * tile_rows * dim``; a READ tile is a
    copy and counts 0.  Popcounts are summed in int64, so they are exact
    in every bitmap dtype.
    """
    a = _host(bitmaps) if isinstance(bitmaps, torch.Tensor) else np.asarray(bitmaps)
    counts = (a != 0).sum(axis=-1, dtype=np.int64)
    mac_tiles = counts > 1 if dynamic_switch else counts > 0
    return int(mac_tiles.sum()) * 2 * a.shape[-1] * dim
