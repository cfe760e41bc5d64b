"""Sharded multi-table crossbar reduction: the single-device emulation.

The port of ``repro.kernels.sharded``'s ``mesh=None`` path (DESIGN.md
§4): each shard's slice of the fused multi-table image runs the
query-blocked kernel over its own tile schedule, and the per-shard
partial sums are combined in float32.  On one card the shard loop runs
in-program; the block axis is split into ``combine_chunks`` contiguous
chunks, one kernel launch each, as the reference does.

:func:`patch_shard_images` is the device half of online replanning: it
copies only a plan patch's tiles from the host master image into the
stacked shard images, in place.

The multi-device path (``shard_map`` in the reference) comes with the
``torch.distributed`` slice of the port; passing ``mesh=`` raises until
then.  PyTorch runs eagerly, so the reference's jit-dispatch caches have
no counterpart: :func:`dispatch_cache_stats` keeps their report schema
with zero counts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda

_DISPATCH_CACHE_NAMES = ("emulated", "mesh", "mesh_subset", "mesh_single")


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (one shard per device, combined by collectives) comes "
            "with the torch.distributed slice of the port; pass mesh=None "
            "to emulate the shards on one device"
        )


def dispatch_cache_stats() -> dict:
    """The reference's dispatch-cache report, all zero (no jit here)."""
    zero = {"hits": 0, "misses": 0, "currsize": 0, "maxsize": 0}
    out = {name: dict(zero) for name in _DISPATCH_CACHE_NAMES}
    out["total"] = {"hits": 0, "misses": 0, "maxsize": 0}
    return out


def _chunk_bounds(nb: int, combine_chunks: int) -> list[tuple[int, int]]:
    """Contiguous, roughly equal block-axis chunks."""
    chunks = max(1, min(combine_chunks, nb)) if nb else 1
    if nb == 0:
        return [(0, 0)]
    base, rem = divmod(nb, chunks)
    bounds, start = [], 0
    for c in range(chunks):
        end = start + base + (1 if c < rem else 0)
        bounds.append((start, end))
        start = end
    return bounds


def crossbar_reduce_sharded(
    images: torch.Tensor,    # (S, local_tiles, tile_rows, dim) stacked shard images
    tile_ids: torch.Tensor,  # (P, nb, max_tiles) int32 shard-local ids, -1 pad
    bitmaps: torch.Tensor,   # (P, nb, max_tiles, q_block, tile_rows)
    *,
    mesh=None,
    combine_chunks: int = 1,
    dynamic_switch: bool = True,
    shard_ids=None,          # (P,) global shard ids of the stacked schedules
) -> torch.Tensor:
    """Shard-local query-blocked reduction + float32 combine.

    Args:
      images: per-shard local images from ``ShardPlan.build_shard_images``
        (trailing padding tiles zero).  Always the full ``S``-deep stack,
        even for a subset dispatch.
      tile_ids / bitmaps: stacked shard-local blocked batch from
        ``shard_block_queries`` (every shard shares the block axis).
      mesh: must be ``None`` (see the module docstring).
      combine_chunks: block-axis chunks, one kernel launch each.
      shard_ids: for a batch compiled for a shard subset, the global
        shard id of each stacked schedule; only those shards' kernels
        run.  ``None`` = all shards.

    Returns:
      ``(nb * q_block, dim)`` summed reduction in block-major query order,
      in the image dtype: each shard's kernel output is cast to float32,
      the shards are summed in participant order, and the sum is cast back.
    """
    _no_mesh(mesh)
    S, _, _, dim = images.shape
    if shard_ids is None:
        if tile_ids.shape[0] != S or bitmaps.shape[0] != S:
            raise ValueError(
                f"shard axes disagree: images {images.shape[0]}, "
                f"tile_ids {tile_ids.shape[0]}, bitmaps {bitmaps.shape[0]}"
            )
        part = np.arange(S, dtype=np.int64)
    else:
        part = np.asarray(shard_ids, dtype=np.int64)
        if tile_ids.shape[0] != part.size or bitmaps.shape[0] != part.size:
            raise ValueError(
                f"shard_ids has {part.size} entries, schedules have "
                f"{tile_ids.shape[0]}/{bitmaps.shape[0]}"
            )
        if part.size and (part.min() < 0 or part.max() >= S):
            raise ValueError(f"shard_ids {part} out of range for {S} shards")

    nb, q_block = bitmaps.shape[1], bitmaps.shape[3]
    bounds = _chunk_bounds(nb, combine_chunks)
    out = torch.zeros((nb * q_block, dim), dtype=torch.float32, device=images.device)
    for p, s in enumerate(part.tolist()):
        parts = [
            crossbar_reduce_cuda(
                images[s], tile_ids[p, c0:c1], bitmaps[p, c0:c1],
                dynamic_switch=dynamic_switch,
            ).float()
            for c0, c1 in bounds
        ]
        out += torch.cat(parts, dim=0)
    return out.to(images.dtype)


def crossbar_reduce_tables(
    images: torch.Tensor,
    sbq,
    spans,
    *,
    mesh=None,
    combine_chunks: int = 1,
    dynamic_switch: bool = True,
) -> list[torch.Tensor]:
    """Multi-table entry: one fused sharded reduction, split per table.

    ``sbq`` is the fused :class:`~repro_torch.core.reduction.
    ShardedBlockedQueries` (per-table compiles offset into the fused tile
    space, concatenated with ``concat_compiled_queries``), ``spans`` the
    per-table ``(row_start, batch)`` list that call returned.

    Returns one ``(batch_t, dim)`` tensor per table, padding rows sliced.
    """
    out = crossbar_reduce_sharded(
        images, sbq.tile_ids, sbq.bitmaps,
        mesh=mesh, combine_chunks=combine_chunks,
        dynamic_switch=dynamic_switch, shard_ids=sbq.shards,
    )
    return [out[start : start + batch] for start, batch in spans]


def resize_shard_images(images: torch.Tensor, capacity: int) -> torch.Tensor:
    """The image stack at a per-shard depth of ``capacity`` slots.

    Growing allocates one zero-padded stack and copies the old one in (a
    transient of both stacks on the device); shrinking copies the kept
    slots into a new contiguous stack, so the old storage is released
    (a slice alone would be a view that keeps it alive, and for more than
    one shard a non-contiguous one).  An unchanged depth returns
    ``images`` itself.
    """
    S, depth = images.shape[0], images.shape[1]
    if capacity > depth:
        out = images.new_zeros((S, capacity) + tuple(images.shape[2:]))
        out[:, :depth] = images
        return out
    if capacity < depth:
        return images[:, :capacity].clone(memory_format=torch.contiguous_format)
    return images


def stage_patch_tiles(
    writes, fused_image: np.ndarray, dtype: torch.dtype, *, pin: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Host half of a patch: gathers the written tiles from the master
    image with NumPy, in ``dtype``.

    Returns ``(index, tiles)``: ``(2, n)`` int64 shard and slot indices
    and the ``(n, tile_rows, dim)`` tiles.  With ``pin`` both live in
    page-locked memory allocated by PyTorch's pinned-memory allocator,
    which keeps each block alive until a copy queued from it has run.
    """
    w = np.asarray(writes, dtype=np.int64).reshape(-1, 3)
    index = torch.from_numpy(np.ascontiguousarray(w[:, :2].T))
    tiles = torch.from_numpy(np.take(fused_image, w[:, 2], axis=0)).to(dtype)
    if pin:
        index, tiles = index.pin_memory(), tiles.pin_memory()
    return index, tiles


def upload_patch_tiles(
    index: torch.Tensor, tiles: torch.Tensor, device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Copies the staged patch to ``device`` on the current stream,
    without a host wait when the staging is pinned."""
    return (index.to(device, non_blocking=True),
            tiles.to(device, non_blocking=True))


def scatter_patch_tiles(
    images: torch.Tensor, index: torch.Tensor, tiles: torch.Tensor
) -> None:
    """Writes ``tiles`` into ``images[index[0], index[1]]`` in place, with
    one indexed assignment on the current stream."""
    images[index[0], index[1]] = tiles


def patch_shard_images(
    images: torch.Tensor,      # (S, capacity, tile_rows, dim) stacked shard images
    patch,                     # repro_torch.dist.replan.PlanPatch (duck-typed)
    fused_image: np.ndarray,   # (num_tiles, tile_rows, dim) host master copy
) -> torch.Tensor:
    """Copies ONLY a plan patch's tiles into the stacked shard images.

    The device half of online replanning (DESIGN.md §6): the host master
    image is the source, and the update is one batched indexed
    assignment of the patch's writes — never a rebuild of the stack.
    Slots freed by demotions keep their stale bytes; the plan stops
    addressing them.  A ``new_capacity`` above the current depth grows
    the stack with zero tiles first; one below it (slack age-out) shrinks
    it to a new stack, releasing the old one.

    On the card the tiles are staged in pinned memory, copied with
    ``non_blocking=True`` and written on the current stream: nothing here
    waits for the card or reads device data back.

    **In place**, unlike the reference's functional ``.at[].set``: when
    the depth is unchanged, ``images`` itself is written and returned.  A
    caller that needs the old image clones it first.

    Args:
      images: the serving image stack (``ShardPlan.build_shard_images``
        output, possibly already patched or slack-padded).
      patch: the :class:`~repro_torch.dist.replan.PlanPatch` being
        applied; only ``dma``, ``fetch_dma``, ``moved`` and
        ``new_capacity`` are read.
      fused_image: the fused multi-table host image the plan indexes
        (:func:`~repro_torch.dist.shard_plan.build_fused_image`).

    Returns:
      The patched stack: ``images`` itself unless the depth changed.
    """
    images = resize_shard_images(images, int(patch.new_capacity))
    # (shard, slot, fused_tile): promotions' new holders, paged-in tiles,
    # then slack age-out's relocations
    writes = list(patch.dma)
    writes += list(getattr(patch, "fetch_dma", ()) or ())
    writes += [(s, new, t) for s, t, _old, new in patch.moved]
    if writes:
        index, tiles = stage_patch_tiles(
            writes, fused_image, images.dtype, pin=images.is_cuda
        )
        index, tiles = upload_patch_tiles(index, tiles, images.device)
        scatter_patch_tiles(images, index, tiles)
    return images


def combine_bytes_per_batch(
    out_rows: int, dim: int, num_shards: int, *, dtype_bytes: int = 4,
) -> int:
    """Cross-shard combine traffic of one batch, summed over shards.

    Ring accounting: a reduce-scatter (or all-gather) of an ``R × dim``
    f32 payload moves ``(S-1)/S × R × dim × 4`` bytes per shard; both
    combine modes cost two such passes (reduce-scatter + all-gather, or a
    ring all-reduce).  Payloads are OUTPUT-sized.  The single-device
    emulation moves none of it; the figure is what a multi-device combine
    of the same batch would move.
    """
    if num_shards <= 1:
        return 0
    per_shard = (num_shards - 1) / num_shards * out_rows * dim * dtype_bytes
    passes = 2  # reduce-scatter + all-gather, or all-reduce
    return int(passes * per_shard * num_shards)
