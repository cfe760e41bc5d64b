"""Sharded multi-table crossbar reduction: the single-device emulation
and the multi-process combine.

The port of ``repro.kernels.sharded`` (DESIGN.md §4): each shard's slice
of the fused multi-table image runs the query-blocked kernel over its own
tile schedule, and the per-shard partial sums are combined in float32.
The block axis is split into ``combine_chunks`` contiguous chunks, one
kernel launch each, as the reference does.

Two execution paths, equal on integer-valued tables (elsewhere the
collectives may sum in another order):

  * **emulation** (``mesh=None``): a loop over the shard axis on one
    device, summing the participants' partials in order.
  * **mesh** (``mesh=`` a :class:`~repro_torch.dist.mesh.ShardMesh`, one
    process per shard, the counterpart of the reference's ``shard_map``).
    The call is SPMD: every rank passes its OWN shard image
    ``(1, depth, tile_rows, dim)`` and its own schedule ``(1, nb,
    max_tiles[, q_block, tile_rows])`` (all ``-1`` on a non-participant),
    with ``shard_ids`` identical on every rank.  Per chunk each rank runs
    the kernel, casts the partial to float32 and launches the chunk's
    collective with ``async_op=True``, so chunk *c*'s combine overlaps
    chunk *c+1*'s kernel.  The reference's three branches:

      - full axis: ``reduce_scatter_tensor`` over the embedding dim, then
        one ``all_gather_into_tensor`` (``combine="psum_scatter"`` and
        ``dim % S == 0``; each partial laid out ``(S, rows, dim/S)``,
        since both collectives split dim 0), else ``all_reduce``; every
        rank joins, a non-participant with an exact-zero partial;
      - a subset whose size divides ``S``: ``all_reduce`` on the
        participants' cached subgroup; the other ranks run nothing.  The
        reference also rings the non-participants in equal-sized groups,
        a TPU lowering rule that changes no value; dropping it changes
        no accounting either (``combine_bytes_per_batch``);
      - a single participant: no collective.

    The result, ``(nb·q_block, dim)`` cast once to the image dtype, lands
    on every participant.  Rank 0 is the controller: when it is not a
    participant of a subset or single flush, the first participant sends
    it the result in one point-to-point transfer (:func:`result_bytes`).
    gloo takes CUDA tensors in every collective used here but not in
    ``send``/``recv`` (torch 2.11 on an H100: the sender's socket write
    fails on the device pointer), so on a gloo data plane a card's result
    crosses through host memory.

:func:`patch_shard_images` is the device half of online replanning: it
copies only a plan patch's tiles from the host master image into the
shard images, in place; under a mesh each rank writes only its own
shard's tiles, which rank 0 sends it.  :func:`distribute_shard_images`
hands each rank its shard of a freshly built image stack.

PyTorch runs eagerly, so the reference's jit-dispatch caches have no
counterpart: :func:`dispatch_cache_stats` keeps their report schema, with
the mesh's subgroup cache under ``"mesh_subset"``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist.mesh import ShardMesh, mesh_errors
from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda

_DISPATCH_CACHE_NAMES = ("emulated", "mesh", "mesh_subset", "mesh_single")
#: the cross-shard combines, in the order of their control-header codes
COMBINES = ("psum_scatter", "psum")


def dispatch_cache_stats(mesh: ShardMesh | None = None) -> dict:
    """The reference's dispatch-cache report: zero for the paths that
    cache nothing here, and the subgroup cache of ``mesh`` (its real hits
    and misses) under ``"mesh_subset"``."""
    zero = {"hits": 0, "misses": 0, "currsize": 0, "maxsize": 0}
    out = {name: dict(zero) for name in _DISPATCH_CACHE_NAMES}
    if mesh is not None:
        out["mesh_subset"] = mesh.cache_stats()
    out["total"] = {
        "hits": sum(out[n]["hits"] for n in _DISPATCH_CACHE_NAMES),
        "misses": sum(out[n]["misses"] for n in _DISPATCH_CACHE_NAMES),
        "maxsize": out["mesh_subset"]["maxsize"],
    }
    return out


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, ShardMesh):
        raise TypeError(
            f"mesh= takes a repro_torch.dist.mesh.ShardMesh (one process per "
            f"shard), got {type(mesh).__name__}"
        )


def combine_route(num_shards: int, participants, dim: int, combine: str) -> str:
    """Which combine a flush of ``participants`` runs on a mesh of
    ``num_shards``: ``"single"`` (no collective), ``"subset"`` (all-reduce
    on the participants' subgroup), ``"scatter"`` (full-axis
    reduce-scatter + all-gather) or ``"psum"`` (full-axis all-reduce)."""
    p = len(participants)
    if p == 1:
        return "single"
    if p < num_shards and num_shards % p == 0:
        return "subset"
    return "scatter" if combine == "psum_scatter" and dim % num_shards == 0 else "psum"


def result_bytes(num_shards: int, participants, rows: int, dim: int,
                 combine: str, dtype_bytes: int) -> int:
    """Bytes of the point-to-point result send to rank 0 of one mesh
    flush: the whole result when rank 0 is outside a subset or single
    flush, else 0 (a full-axis combine hands every rank the result)."""
    route = combine_route(num_shards, participants, dim, combine)
    if route in ("single", "subset") and 0 not in {int(p) for p in participants}:
        return rows * dim * dtype_bytes
    return 0


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
    images: torch.Tensor,    # (S, local_tiles, tile_rows, dim); (1, ...) under a mesh
    tile_ids: torch.Tensor,  # (P, nb, max_tiles) int32 shard-local ids, -1 pad
    bitmaps: torch.Tensor,   # (P, nb, max_tiles, q_block, tile_rows)
    *,
    mesh: ShardMesh | None = None,
    axis_name: str = "model",
    combine: str = "psum_scatter",
    combine_chunks: int = 1,
    dynamic_switch: bool = True,
    shard_ids=None,          # (P,) global shard ids of the stacked schedules
) -> torch.Tensor | None:
    """Shard-local query-blocked reduction + float32 combine.

    Args:
      images: emulated, the per-shard local images from
        ``ShardPlan.build_shard_images`` (trailing padding tiles zero),
        always the full ``S``-deep stack; under a mesh, this rank's shard
        only, ``(1, depth, tile_rows, dim)``.
      tile_ids / bitmaps: emulated, the stacked shard-local blocked batch
        from ``shard_block_queries`` (every shard shares the block axis);
        under a mesh, this rank's own schedule ``(1, ...)``, all ``-1``
        (zero bitmaps) on a rank that does not participate.
      mesh: a :class:`~repro_torch.dist.mesh.ShardMesh` whose size is the
        shard count, to combine across processes (see the module
        docstring); ``None`` emulates the shards on one device.
      axis_name: the mesh axis the shards lie on (``"model"``).
      combine: ``"psum_scatter"`` (reduce-scatter over the embedding dim
        + all-gather; all-reduce when ``dim % S != 0``) or ``"psum"``.
      combine_chunks: block-axis chunks, one kernel launch (and, under a
        mesh, one collective) each.
      shard_ids: for a batch compiled for a shard subset, the global
        shard id of each stacked schedule (under a mesh: the
        participants, identical on every rank); only those shards'
        kernels run.  ``None`` = all shards.

    Returns:
      ``(nb * q_block, dim)`` summed reduction in block-major query order,
      in the image dtype: each kernel output is cast to float32, the
      shards are summed, and the sum is cast back once.  Under a mesh the
      result is returned on every rank that holds it (the participants,
      rank 0, and every rank of a full-axis combine) and ``None`` on the
      others.
    """
    _check_mesh(mesh)
    if mesh is None:
        S = images.shape[0]
    else:
        S = mesh.size
        mesh_axis = {"data": 1, "model": mesh.size}.get(axis_name)
        if mesh_axis != S:
            raise ValueError(
                f"mesh axis {axis_name!r} has size {mesh_axis}, need {S} shards"
            )
        if images.shape[0] != 1 or tile_ids.shape[0] != 1 or bitmaps.shape[0] != 1:
            raise ValueError(
                "under a mesh each rank passes its own shard: images, tile_ids "
                f"and bitmaps of leading size 1, got {images.shape[0]}, "
                f"{tile_ids.shape[0]}, {bitmaps.shape[0]}"
            )
    if shard_ids is None:
        if mesh is None and (tile_ids.shape[0] != S or bitmaps.shape[0] != S):
            raise ValueError(
                f"shard axes disagree: images {images.shape[0]}, "
                f"tile_ids {tile_ids.shape[0]}, bitmaps {bitmaps.shape[0]}"
            )
        part = np.arange(S, dtype=np.int64)
    else:
        part = np.asarray(shard_ids, dtype=np.int64)
        if mesh is None and (tile_ids.shape[0] != part.size
                             or bitmaps.shape[0] != part.size):
            raise ValueError(
                f"shard_ids has {part.size} entries, schedules have "
                f"{tile_ids.shape[0]}/{bitmaps.shape[0]}"
            )
        if part.size and (part.min() < 0 or part.max() >= S):
            raise ValueError(f"shard_ids {part} out of range for {S} shards")
    if combine not in COMBINES:
        raise ValueError(f"unknown combine {combine!r}")

    bounds = _chunk_bounds(bitmaps.shape[1], combine_chunks)
    if mesh is not None:
        return _reduce_mesh(images[0], tile_ids[0], bitmaps[0], mesh, part,
                            combine, bounds, dynamic_switch)
    nb, q_block, dim = bitmaps.shape[1], bitmaps.shape[3], images.shape[-1]
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


def _reduce_mesh(image, ids, bms, mesh: ShardMesh, part: np.ndarray, combine: str,
                 bounds, dynamic_switch: bool) -> torch.Tensor | None:
    """One rank's share of a mesh flush (see the module docstring)."""
    S, me = mesh.size, mesh.rank
    rows, dim = bms.shape[0] * bms.shape[2], image.shape[-1]
    route = combine_route(S, part, dim, combine)
    # every rank asks for the subgroup: its first creation is collective
    group = mesh.subgroup(part) if route == "subset" else mesh.data
    members = {int(p) for p in part}
    first = int(part[0])
    # gloo's point-to-point transfers hand the tensor's pointer to the
    # socket, so on a card they go through host memory
    staged = mesh.backend == "gloo" and image.is_cuda
    if me not in members and route in ("single", "subset"):
        if me != 0:
            return None
        out = torch.empty((rows, dim), dtype=image.dtype,
                          device="cpu" if staged else image.device)
        with mesh_errors(f"result recv from rank {first}"):
            dist.recv(out, src=first, group=mesh.data)
        return out.to(image.device)
    timed = mesh.record_combine and image.is_cuda and route != "single"
    works, outs, start = [], [], None
    width = dim // S
    for c0, c1 in bounds:
        p = crossbar_reduce_cuda(
            image, ids[c0:c1], bms[c0:c1], dynamic_switch=dynamic_switch
        ).float()
        if timed and start is None:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        with mesh_errors(f"{route} combine"):
            if route == "scatter":
                # rank r's slice of the reduced partial is columns
                # [r·dim/S, (r+1)·dim/S): lay the partial out (S, rows, dim/S)
                x = p.reshape(-1, S, width).transpose(0, 1).contiguous()
                y = torch.empty((p.shape[0], width), dtype=p.dtype, device=p.device)
                works.append(dist.reduce_scatter_tensor(
                    y, x.reshape(-1, width), group=group, async_op=True))
                p = y
            elif route != "single":
                works.append(dist.all_reduce(p, group=group, async_op=True))
        outs.append(p)
    with mesh_errors(f"{route} combine"):
        for w in works:
            w.wait()
        out = torch.cat(outs, dim=0)
        if route == "scatter":
            full = torch.empty((S * rows, width), dtype=out.dtype, device=out.device)
            dist.all_gather_into_tensor(full, out, group=group)
            out = full.reshape(S, rows, width).transpose(0, 1).reshape(rows, dim)
    if timed:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        mesh.combine_events.append((start, end))
    out = out.to(image.dtype)
    if route in ("single", "subset") and 0 not in members and me == first:
        with mesh_errors("result send to rank 0"):
            dist.send(out.cpu() if staged else out, dst=0, group=mesh.data)
    return out


def crossbar_reduce_tables(
    images: torch.Tensor,
    sbq,
    spans,
    *,
    mesh: ShardMesh | None = None,
    axis_name: str = "model",
    combine: str = "psum_scatter",
    combine_chunks: int = 1,
    dynamic_switch: bool = True,
) -> list[torch.Tensor] | None:
    """Multi-table entry: one fused sharded reduction, split per table.

    ``sbq`` is the fused :class:`~repro_torch.core.reduction.
    ShardedBlockedQueries` (per-table compiles offset into the fused tile
    space, concatenated with ``concat_compiled_queries``), ``spans`` the
    per-table ``(row_start, batch)`` list that call returned.  Under a
    mesh ``sbq`` holds this rank's own schedule (see
    :func:`crossbar_reduce_sharded`) and ``sbq.shards`` the participants.

    Returns one ``(batch_t, dim)`` tensor per table, padding rows sliced
    (``None`` on a mesh rank that does not receive the result).
    """
    out = crossbar_reduce_sharded(
        images, sbq.tile_ids, sbq.bitmaps,
        mesh=mesh, axis_name=axis_name, combine=combine,
        combine_chunks=combine_chunks, dynamic_switch=dynamic_switch,
        shard_ids=sbq.shards,
    )
    if out is None:
        return None
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


def _patch_writes(patch) -> np.ndarray:
    """A patch's ``(shard, slot, fused_tile)`` writes, ``(n, 3)`` int64:
    promotions' new holders, paged-in tiles, then slack age-out's
    relocations."""
    writes = list(patch.dma)
    writes += list(getattr(patch, "fetch_dma", ()) or ())
    writes += [(s, new, t) for s, t, _old, new in patch.moved]
    return np.asarray(writes, dtype=np.int64).reshape(-1, 3)


def patch_shard_images(
    images: torch.Tensor,      # (S, capacity, tile_rows, dim); (1, ...) under a mesh
    patch,                     # repro_torch.dist.replan.PlanPatch (duck-typed)
    fused_image: np.ndarray,   # (num_tiles, tile_rows, dim) host master copy
    *,
    mesh: ShardMesh | None = None,
) -> torch.Tensor:
    """Copies ONLY a plan patch's tiles into the shard images.

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

    Under a mesh the call is SPMD: rank 0 passes the patch and the master
    image, every other rank ``None`` for both; each rank passes its own
    shard ``(1, depth, tile_rows, dim)``.  Rank 0 sends each rank the
    patch's depth and that shard's slots and tiles on the control plane;
    every rank resizes its shard and writes only its own tiles.

    Args:
      images: the serving image stack (``ShardPlan.build_shard_images``
        output, possibly already patched or slack-padded), or this rank's
        shard of it under a mesh.
      patch: the :class:`~repro_torch.dist.replan.PlanPatch` being
        applied; only ``dma``, ``fetch_dma``, ``moved`` and
        ``new_capacity`` are read.
      fused_image: the fused multi-table host image the plan indexes
        (:func:`~repro_torch.dist.shard_plan.build_fused_image`).
      mesh: the :class:`~repro_torch.dist.mesh.ShardMesh`, or ``None``.

    Returns:
      The patched stack: ``images`` itself unless the depth changed.
    """
    _check_mesh(mesh)
    if mesh is None:
        images = resize_shard_images(images, int(patch.new_capacity))
        writes = _patch_writes(patch)
    elif mesh.rank == 0:
        w = _patch_writes(patch)
        capacity = int(patch.new_capacity)
        for r in range(1, mesh.size):
            mine = w[w[:, 0] == r]
            mesh.send(torch.tensor([len(mine), capacity]), r)
            if len(mine):
                mesh.send(torch.from_numpy(np.ascontiguousarray(mine[:, 1])), r)
                mesh.send(torch.from_numpy(np.take(fused_image, mine[:, 2], axis=0))
                          .to(images.dtype), r)
        images = resize_shard_images(images, capacity)
        writes = w[w[:, 0] == 0]
    else:
        n, capacity = mesh.recv((2,), torch.int64).tolist()
        images = resize_shard_images(images, capacity)
        if n:
            slots = mesh.recv((n,), torch.int64)
            tiles = mesh.recv((n,) + tuple(images.shape[2:]), images.dtype)
            index = torch.stack([torch.zeros_like(slots), slots])
            index, tiles = upload_patch_tiles(index, tiles, images.device)
            scatter_patch_tiles(images, index, tiles)
        return images
    if len(writes):
        index, tiles = stage_patch_tiles(
            writes, fused_image, images.dtype, pin=images.is_cuda
        )
        index, tiles = upload_patch_tiles(index, tiles, images.device)
        scatter_patch_tiles(images, index, tiles)
    return images


#: tiles per control-plane message of :func:`distribute_shard_images`
_IMAGE_CHUNK_TILES = 4096
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def distribute_shard_images(
    images: np.ndarray | None, mesh: ShardMesh, dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Hands each rank its shard of a freshly built image stack.

    SPMD: rank 0 passes the host stack ``(S, depth, tile_rows, dim)`` and
    the image ``dtype``; every other rank passes ``None``.  Rank 0 sends
    each rank its shard, in ``dtype``, in slices of
    ``_IMAGE_CHUNK_TILES`` tiles; each rank copies its shard to its
    device slice by slice.

    Returns:
      This rank's ``(1, depth, tile_rows, dim)`` shard on ``mesh.device``.
    """
    _check_mesh(mesh)
    if mesh.rank == 0:
        if images.shape[0] != mesh.size:
            raise ValueError(f"image stack of {images.shape[0]} shards on a mesh "
                             f"of {mesh.size} ranks")
        shape = tuple(int(x) for x in images.shape[1:])
        for r in range(1, mesh.size):
            mesh.send(torch.tensor(shape + (_DTYPES.index(dtype),)), r)
            for a in range(0, shape[0], _IMAGE_CHUNK_TILES):
                mesh.send(torch.from_numpy(images[r, a:a + _IMAGE_CHUNK_TILES]).to(dtype), r)
        return torch.from_numpy(images[:1]).to(device=mesh.device, dtype=dtype)
    *shape, code = mesh.recv((4,), torch.int64).tolist()
    dtype = _DTYPES[code]
    out = torch.empty((1, *shape), dtype=dtype, device=mesh.device)
    for a in range(0, shape[0], _IMAGE_CHUNK_TILES):
        part = mesh.recv((min(_IMAGE_CHUNK_TILES, shape[0] - a), *shape[1:]), dtype)
        out[0, a:a + part.shape[0]] = part.to(mesh.device)
    return out


def combine_bytes_per_batch(
    out_rows: int, dim: int, num_shards: int, *, dtype_bytes: int = 4,
) -> int:
    """Cross-shard combine traffic of one batch, summed over shards.

    Ring accounting: a reduce-scatter (or all-gather) of an ``R × dim``
    f32 payload moves ``(S-1)/S × R × dim × 4`` bytes per shard; both
    combine modes cost two such passes (reduce-scatter + all-gather, or a
    ring all-reduce).  Payloads are OUTPUT-sized.  The single-device
    emulation moves none of it; the figure is what a multi-device combine
    of the same batch would move under the reference's ring rule (the
    mesh path's subgroup all-reduce moves the same, since the
    non-participant groups the reference adds carry no payload of the
    flush).
    """
    if num_shards <= 1:
        return 0
    per_shard = (num_shards - 1) / num_shards * out_rows * dim * dtype_bytes
    passes = 2  # reduce-scatter + all-gather, or all-reduce
    return int(passes * per_shard * num_shards)
