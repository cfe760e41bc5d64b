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
the host work runs on float32 copies.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.cooccurrence import segment_ranks
from repro_torch.core.mapping import CrossbarLayout, compile_activations


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
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


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
    acts = compile_activations(
        layout, queries,
        balance_replicas=balance_replicas, replica_block=replica_block,
    )
    batch = acts.batch
    per_q = acts.per_query_tiles()
    width = int(per_q.max()) if per_q.size else 1
    max_tiles = _padded_width(width, max_tiles, "query")

    tile_ids = np.full((batch, max_tiles), -1, dtype=np.int32)
    bitmaps = np.zeros((batch, max_tiles, layout.tile_rows), dtype=np.float32)
    # slot position of each activation within its query (activations are
    # (query, tile)-sorted, so the run-local rank is the position)
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
    """

    tile_ids: torch.Tensor   # (P, nb, max_tiles) int32 shard-LOCAL ids, -1 pad
    bitmaps: torch.Tensor    # (P, nb, max_tiles, q_block, tile_rows)
    q_block: int
    batch: int               # original (unpadded) query count
    shard_widths: np.ndarray  # (P,) widest per-shard block union, pre-pad
    shards: np.ndarray | None = None  # (P,) global shard ids of the stack
    # (None = all shards in order, the full-flush compile)

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
    """
    if q_block < 1:
        raise ValueError("q_block must be >= 1")
    device = cq.tile_ids.device if device is None else device
    dtype = cq.bitmaps.dtype
    S = int(plan.num_shards)
    if participants is None:
        parts = np.arange(S, dtype=np.int64)
        shards_field = None
    else:
        parts = np.asarray(list(participants), dtype=np.int64)
        if parts.size == 0 or parts.size != np.unique(parts).size:
            raise ValueError(f"participants must be non-empty unique ids, got {parts}")
        if parts.min() < 0 or parts.max() >= S:
            raise ValueError(f"participants {parts} out of range for {S} shards")
        shards_field = parts
    P = int(parts.size)
    ids, bms, nb = _pad_to_blocks(_host(cq.tile_ids), _host(cq.bitmaps), q_block)
    batch = cq.tile_ids.shape[0]
    tile_rows = bms.shape[-1]
    nb_safe = max(nb, 1)

    vq, vs = np.nonzero(ids >= 0)
    vt = ids[vq, vs].astype(np.int64)
    vblk = vq // q_block
    shard_of_tile = np.asarray(plan.shard_of_tile)
    own = shard_of_tile[vt].astype(np.int64)
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
    blocked_bms = np.zeros(
        (P, nb_safe, max_tiles, q_block, tile_rows), dtype=bms.dtype
    )
    pos_entry = pos_u[np.searchsorted(uniq, key)]
    blocked_bms[pos_own, vblk, pos_entry, vq % q_block] = bms[vq, vs]
    widths = per_sb.reshape(P, nb_safe).max(axis=1) if uniq.size else np.zeros(P, np.int64)
    return ShardedBlockedQueries(
        tile_ids=_to_device(blocked_ids, device),
        bitmaps=_to_device(blocked_bms, device, dtype),
        q_block=q_block,
        batch=batch,
        shard_widths=widths.astype(np.int64),
        shards=shards_field,
    )


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
