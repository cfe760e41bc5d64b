"""Sharded multi-table crossbar reduction: the single-device emulation.

The port of ``repro.kernels.sharded``'s ``mesh=None`` path (DESIGN.md
§4): each shard's slice of the fused multi-table image runs the
query-blocked kernel over its own tile schedule, and the per-shard
partial sums are combined in float32.  On one card the shard loop runs
in-program; the block axis is split into ``combine_chunks`` contiguous
chunks, one kernel launch each, as the reference does.

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
