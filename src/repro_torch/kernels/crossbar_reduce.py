"""Crossbar reduction with the dynamic READ/MAC switch: the CUDA wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/crossbar_reduce.py``
(``crossbar_reduce_pallas`` and its bodies ``_kernel``, flat, and
``_blocked_kernel``, query-blocked) with the hand-written CUDA C++ kernel
in ``csrc/crossbar_reduce.cu``.

What bounds it on an H100: memory.  Each non-padding slot reads one
``(tile_rows, dim)`` tile and multiplies it by a ``(q_block, tile_rows)``
0/1 bitmap: 2·q flops per tile element, about 4 flop/byte at q=8 with an
f32 image, far below the card's ridge.  The least bytes are one tile per
non-padding slot, plus the bitmaps and tile ids, plus one write of the
output.  A serving flush holds only 16 query blocks, so the kernel must
keep many bytes in flight from few blocks: the slots of a query block, up
to its row's last non-padding one, are split over a thread-block cluster
of ``n_split`` CUDA blocks (contiguous ranges,
``kernels.ref.crossbar_slot_ranges``); each block's 4 warps take the slots
of its range in turn with 16-byte row loads, two batches of rows in flight
and the next slot's bitmap loaded under this slot's rows; the partial sums
are added in a fixed order (warps, then the cluster's blocks in rank order,
through distributed shared memory).  :func:`crossbar_launch_plan` gives the
launch; ``kernels.ref.crossbar_reduce_split_ref`` repeats its order of sums.

Tolerance: the kernel adds each query's products in (split, warp, slot,
row) order with one ``fmaf`` each, the plain versions by slot products
summed over slots, so on general tables the two differ by f32 rounding
(``chip_smoke.py``'s ``TOL``); on integer-valued tables every partial sum
is exact and the results are bit-identical.

The kernel serves the reference's whole contract: any ``q_block >= 1``
(chunks of at most 16 queries, each re-reading its tiles), any
``tile_rows`` that is a multiple of 8 (bitmaps staged 64 rows at a time),
any ``dim`` that is a multiple of 128, and f32, bf16 and f16 images.
What it refuses, as deliberate differences from the JAX kernel: an image
of another dtype (JAX would cast an integer image), bitmaps of another
dtype than the image, tile ids that are not int32, non-contiguous inputs,
and image or bitmap data not 16-byte aligned.

On a CPU tensor the wrapper runs the plain version in
:mod:`repro_torch.kernels.ref`; on a CUDA tensor it launches the kernel
or raises.  ``crossbar_reduce_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import KernelError, load_crossbar

__all__ = [
    "CrossbarLaunchPlan", "crossbar_launch_plan", "crossbar_q_chunk",
    "crossbar_reduce_cuda", "crossbar_split_count",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
SPLITS = (1, 2, 4, 8)      # cluster sizes; 8 is the portable limit
Q_CHUNKS = (1, 2, 4, 8, 16)  # queries a CUDA block holds (a template)
THREADS = 128              # 4 warps a block
COLS = 128                 # output columns a block covers
_MAX_GRID_YZ = 65_535
_ALIGN = 16                # bytes: the kernel reads 16-byte vectors


def crossbar_split_count(nb: int, S: int, sms: int = 132, blocks_per_sm: int = 2) -> int:
    """Blocks a cluster splits each query block's slots over.

    ``nb`` is the number of independent CUDA blocks before the split (query
    blocks × column chunks × query chunks), ``blocks_per_sm`` how many of
    the kernel's blocks an SM holds at once.  The largest count in
    :data:`SPLITS` whose blocks all fit one wave (``nb * n_split <=
    blocks_per_sm * sms``), never more than ``S`` (the compile pads a
    schedule only to a multiple of 8 past its widest row), and 1 when not
    even that fits or ``S <= 1``.  A second, partial wave of blocks costs
    more than the shorter slot ranges gain.
    """
    best = 1
    for p in SPLITS:
        if p > S or nb * p > blocks_per_sm * sms:
            break
        best = p
    return best


def crossbar_q_chunk(q_block: int) -> int:
    """Queries a CUDA block holds: the least of :data:`Q_CHUNKS` that
    covers ``q_block``, at most 16 (larger blocks run as several chunks)."""
    return next(c for c in Q_CHUNKS if c >= min(q_block, Q_CHUNKS[-1]))


@dataclasses.dataclass(frozen=True)
class CrossbarLaunchPlan:
    """One launch of the crossbar kernel: ``grid`` (x = query blocks ×
    ``n_split``, y = column chunks, z = query chunks) of ``block``
    threads, clusters of ``n_split`` blocks along x; a block holds
    ``q_chunk`` queries (the template), the last chunk possibly fewer."""

    grid: tuple[int, int, int]
    block: int
    cluster: tuple[int, int, int]
    q_chunk: int
    q_chunks: int
    n_split: int


def crossbar_launch_plan(nb: int, S: int, q_block: int, tile_rows: int, dim: int,
                         *, sms: int = 132, blocks_per_sm: int = 2,
                         n_split: int | None = None) -> CrossbarLaunchPlan:
    """The kernel's launch for ``nb`` query blocks of ``S`` slots and
    ``q_block`` queries over ``(tile_rows, dim)`` tiles, on a card of
    ``sms`` SMs that holds ``blocks_per_sm`` of the kernel's blocks each.
    ``n_split`` forces the split (tests and ``chip_smoke.py``); ``None``
    takes :func:`crossbar_split_count`.  Raises what the kernel cannot
    take."""
    if q_block < 1:
        raise ValueError(f"q_block={q_block} must be >= 1")
    if dim % COLS != 0 or dim <= 0:
        raise ValueError(f"dim={dim} must be a positive multiple of {COLS}")
    if tile_rows % 8 != 0 or tile_rows <= 0:
        raise ValueError(f"tile_rows={tile_rows} must be a positive multiple of 8")
    q_chunk = crossbar_q_chunk(q_block)
    q_chunks = -(-q_block // q_chunk)
    if dim // COLS > _MAX_GRID_YZ or q_chunks > _MAX_GRID_YZ:
        raise ValueError(f"dim={dim} or q_block={q_block} exceeds the grid")
    if n_split is None:
        n_split = crossbar_split_count(nb * (dim // COLS) * q_chunks, S, sms, blocks_per_sm)
    elif n_split not in SPLITS:
        raise ValueError(f"n_split={n_split} not in {SPLITS}")
    return CrossbarLaunchPlan(
        grid=(nb * n_split, dim // COLS, q_chunks), block=THREADS,
        cluster=(n_split, 1, 1), q_chunk=q_chunk, q_chunks=q_chunks, n_split=n_split,
    )


@functools.cache
def _occupancy(index: int, dtype: torch.dtype, q_chunk: int) -> tuple[int, int]:
    """``(SMs, blocks an SM holds)`` of the kernel instance on device ``index``."""
    with torch.cuda.device(index):
        blocks = load_crossbar().crossbar_blocks_per_sm(_DTYPE_CODE[dtype], q_chunk)
    if blocks <= 0:
        raise KernelError(f"crossbar occupancy query failed ({-blocks})")
    return torch.cuda.get_device_properties(index).multi_processor_count, blocks


def _check_shapes(image, tile_ids, bitmaps) -> int:
    """Validates the reference contract; returns q_block (1 when flat)."""
    if image.ndim != 3 or tile_ids.ndim != 2:
        raise ValueError(
            f"image must be (tiles, rows, dim) and tile_ids 2-D, got "
            f"{tuple(image.shape)} / {tuple(tile_ids.shape)}"
        )
    _, tile_rows, dim = image.shape
    batch, max_tiles = tile_ids.shape
    if bitmaps.ndim == 4:
        nb, s_blk, q_block, r = bitmaps.shape
        if (nb, s_blk, r) != (batch, max_tiles, tile_rows):
            raise ValueError(
                f"blocked bitmaps {tuple(bitmaps.shape)} inconsistent with "
                f"tile_ids {tuple(tile_ids.shape)} / tile_rows {tile_rows}"
            )
    elif tuple(bitmaps.shape) != (batch, max_tiles, tile_rows):
        raise ValueError(f"bitmaps shape {tuple(bitmaps.shape)} inconsistent")
    else:
        q_block = 1
    if dim % 128 != 0:
        raise ValueError(f"dim={dim} must be a multiple of 128")
    if tile_rows % 8 != 0:
        raise ValueError(f"tile_rows={tile_rows} must be a multiple of 8")
    return q_block


def crossbar_reduce_cuda(
    image: torch.Tensor,     # (num_tiles, tile_rows, dim)
    tile_ids: torch.Tensor,  # (batch | nb, max_tiles) int32, -1 padding
    bitmaps: torch.Tensor,   # flat (batch, max_tiles, tile_rows)
                             # or blocked (nb, max_tiles, q_block, tile_rows)
    *,
    dynamic_switch: bool = True,
    n_split: int | None = None,
) -> torch.Tensor:
    """``crossbar_reduce_pallas`` counterpart (no autograd; see ops).

    3-D bitmaps give the flat ``(batch, dim)`` reduction, 4-D bitmaps the
    query-blocked ``(nb * q_block, dim)`` one in block-major query order.
    ``dynamic_switch`` selects the READ path for slots with at most one
    active wordline; it never changes the values.  ``n_split`` forces the
    kernel's slot split (one of :data:`SPLITS`); the plain version on CPU
    tensors has no split.
    """
    q_block = _check_shapes(image, tile_ids, bitmaps)
    tensors = (image, tile_ids, bitmaps)
    if all(t.device.type == "cpu" for t in tensors):
        if bitmaps.ndim == 4:
            return _ref.crossbar_reduce_blocked_ref(image, tile_ids, bitmaps)
        return _ref.crossbar_reduce_ref(image, tile_ids, bitmaps)
    device = image.device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            f"image, tile_ids and bitmaps must share one device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if image.dtype not in _DTYPE_CODE:
        raise TypeError(f"image dtype {image.dtype} not in {list(_DTYPE_CODE)}")
    if bitmaps.dtype != image.dtype:
        raise TypeError(f"bitmaps dtype {bitmaps.dtype} != image dtype {image.dtype}")
    if tile_ids.dtype != torch.int32:
        raise TypeError(f"tile_ids dtype {tile_ids.dtype} must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("image, tile_ids and bitmaps must be contiguous")
    num_tiles, tile_rows, dim = image.shape
    if num_tiles == 0:
        raise ValueError("image holds no tiles")
    nb, max_tiles = tile_ids.shape
    out = torch.empty((nb * q_block, dim), dtype=image.dtype, device=device)
    if nb == 0:
        return out
    if image.data_ptr() % _ALIGN or bitmaps.data_ptr() % _ALIGN:
        raise ValueError(f"image and bitmaps data must be {_ALIGN}-byte aligned")
    sms, blocks_per_sm = _occupancy(device.index or 0, image.dtype, crossbar_q_chunk(q_block))
    plan = crossbar_launch_plan(nb, max_tiles, q_block, tile_rows, dim, sms=sms,
                                blocks_per_sm=blocks_per_sm, n_split=n_split)
    lib = load_crossbar()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.crossbar_reduce_launch(
            image.data_ptr(), tile_ids.data_ptr(), bitmaps.data_ptr(),
            out.data_ptr(), num_tiles, tile_rows, dim, nb, max_tiles,
            q_block, plan.q_chunk, plan.n_split, _DTYPE_CODE[image.dtype],
            int(bool(dynamic_switch)), stream,
        )
    if err != 0:
        msg = lib.crossbar_error_string(err).decode()
        raise KernelError(f"crossbar_reduce kernel launch failed: {msg} ({err})")
    crossbar_reduce_cuda.launches += 1
    return out


crossbar_reduce_cuda.launches = 0
