"""Padded embedding bag (gather + sum): the CUDA wrapper.

Replaces the Pallas TPU kernel ``repro/kernels/embedding_bag.py``
(``embedding_bag_pallas`` and its body ``_kernel``) with the hand-written
CUDA C++ kernel in ``csrc/embedding_bag.cu``.  It is the naive / nMARS
datapath that the ReCross crossbar reduction is measured against: each
query gathers its rows by row id and sums them.

What bounds it on an H100: memory, and on the main path's few hundred
bags the latency of the slowest bag's chain of DRAM round trips.  Each
valid lookup reads one row and does one add per element; the least bytes
are the valid rows, the indices and one write of the output.  Each bag's
positions ``[0, K)`` are split into ``n_split`` contiguous ranges
(``kernels.ref.embedding_bag_k_ranges``), each taken by a lane group (a
warp in f32, a half-warp in bf16/f16) that moves 16 bytes of a row a lane,
compacts its valid ids and keeps :data:`ROWS_IN_FLIGHT` row loads in
flight before its first add; the splits of a bag share a CUDA block and their f32 partials are
added in split order through shared memory.  :func:`embedding_bag_launch_plan`
gives the launch; ``kernels.ref.embedding_bag_split_ref`` repeats its
order of sums.

Tolerance: the kernel adds each bag's rows in (split, id) order, the
plain version in its own order, so on general tables the two differ by
f32 rounding (``chip_smoke.py``'s ``TOL``); on integer-valued tables every
partial sum is exact and the results are bit-identical.

The kernel takes f32, bf16 and f16 tables, as the reference does (f32
accumulation, output in the table dtype).  What it refuses, as deliberate
differences from the JAX kernel: indices that are not int32 (JAX casts
int64 indices to int32), a table of another dtype, non-contiguous inputs
and table data not 16-byte aligned.

On a CPU tensor the wrapper runs the plain version in
:mod:`repro_torch.kernels.ref`; on a CUDA tensor it launches the kernel
or raises.  ``embedding_bag_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import KernelError, load_embedding_bag

__all__ = [
    "EmbeddingBagLaunchPlan", "embedding_bag_cuda", "embedding_bag_device_plan",
    "embedding_bag_launch_plan", "embedding_bag_split_count",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
COLS = 128          # columns a lane group covers
THREADS = 256       # a block's threads, unless its splits need more
SPLITS = (1, 2, 4, 8, 16)  # the split rule's candidates
ROWS_IN_FLIGHT = 8  # row loads a lane issues before its first add (kRowsInFlight)
MAX_SPLIT = 16      # the most a caller may force (512 threads in f32, the launch bound)
_MAX_GRID_Y = 65_535
_ALIGN = 16         # bytes: the kernel reads 16-byte vectors


def group_lanes(itemsize: int) -> int:
    """Lanes of a group: 128 columns at 16 bytes a lane (32 in f32, 16 in
    bf16/f16)."""
    if itemsize not in (2, 4):
        raise TypeError(f"the kernel takes 2- or 4-byte tables, not {itemsize}-byte")
    return COLS * itemsize // 16


def embedding_bag_split_count(batch: int, bag: int, chunks: int, groups_per_block: int,
                              sms: int = 132, blocks_per_sm: int = 4) -> int:
    """Ranges each bag's positions are split into.

    ``chunks`` is the number of 128-column chunks, ``groups_per_block``
    the lane groups of a :data:`THREADS`-thread block and
    ``blocks_per_sm`` how many such blocks an SM holds at once.  The
    largest count in :data:`SPLITS` whose blocks all fit one wave
    (``ceil(batch / (groups_per_block // n)) * chunks <= blocks_per_sm *
    sms``) and whose ranges hold at least :data:`ROWS_IN_FLIGHT`
    positions each, never more than ``groups_per_block``; 1 when not even
    2 qualifies.  The grid then fills as much of one wave as it can (a
    second, partial wave costs more than shorter chains gain), and a
    group has a full batch of row loads to issue.
    """
    best = 1
    for n in SPLITS:
        if n * ROWS_IN_FLIGHT > bag or n > groups_per_block:
            break
        if -(-batch // (groups_per_block // n)) * chunks > blocks_per_sm * sms:
            break
        best = n
    return best


@dataclasses.dataclass(frozen=True)
class EmbeddingBagLaunchPlan:
    """One launch of the embedding-bag kernel: ``grid`` (x = groups of
    ``bags_per_block`` bags, y = 128-column chunks) of ``block`` threads,
    ``n_split`` lane groups of ``group_lanes`` lanes a bag."""

    grid: tuple[int, int]
    block: int
    n_split: int
    bags_per_block: int
    group_lanes: int


def embedding_bag_launch_plan(batch: int, bag: int, dim: int, itemsize: int, *,
                              sms: int = 132, blocks_per_sm: int = 4,
                              n_split: int | None = None) -> EmbeddingBagLaunchPlan:
    """The kernel's launch for ``batch`` bags of ``bag`` positions over a
    ``dim``-wide table of ``itemsize``-byte values, on a card of ``sms``
    SMs that holds ``blocks_per_sm`` of the kernel's :data:`THREADS`-thread
    blocks each.  ``n_split`` forces the split (1 to :data:`MAX_SPLIT`;
    tests and ``chip_smoke.py``); ``None`` takes
    :func:`embedding_bag_split_count`.  A forced split wider than a
    :data:`THREADS`-thread block gets a block of its own.  Raises what the
    kernel cannot take."""
    lanes = group_lanes(itemsize)
    if dim % COLS != 0 or dim <= 0:
        raise ValueError(f"dim={dim} must be a positive multiple of {COLS}")
    if dim // COLS > _MAX_GRID_Y:
        raise ValueError(f"dim={dim} exceeds the grid")
    if n_split is None:
        n_split = embedding_bag_split_count(batch, bag, dim // COLS, THREADS // lanes,
                                            sms, blocks_per_sm)
    else:
        _check_n_split(n_split)
    block = max(THREADS, -(-n_split * lanes // 32) * 32)
    bags_per_block = block // lanes // n_split
    return EmbeddingBagLaunchPlan(
        grid=(-(-batch // bags_per_block), dim // COLS), block=block,
        n_split=n_split, bags_per_block=bags_per_block, group_lanes=lanes,
    )


def _check_n_split(n_split) -> None:
    if isinstance(n_split, bool) or not isinstance(n_split, int):
        raise TypeError(f"n_split={n_split!r} must be an int")
    if not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"n_split={n_split} not in 1..{MAX_SPLIT}")


@functools.cache
def _occupancy(index: int, dtype: torch.dtype) -> tuple[int, int]:
    """``(SMs, THREADS-thread blocks an SM holds)`` of the kernel instance
    on device ``index``."""
    with torch.cuda.device(index):
        blocks = load_embedding_bag().embedding_bag_blocks_per_sm(_DTYPE_CODE[dtype], THREADS)
    if blocks <= 0:
        raise KernelError(f"embedding_bag occupancy query failed ({-blocks})")
    return torch.cuda.get_device_properties(index).multi_processor_count, blocks


def embedding_bag_device_plan(table: torch.Tensor, indices: torch.Tensor,
                              n_split: int | None = None) -> EmbeddingBagLaunchPlan:
    """The launch :func:`embedding_bag_cuda` makes for these CUDA tensors:
    :func:`embedding_bag_launch_plan` at the card's SM count and the
    kernel's measured occupancy."""
    sms, blocks_per_sm = _occupancy(table.device.index or 0, table.dtype)
    return embedding_bag_launch_plan(indices.shape[0], indices.shape[1], table.shape[1],
                                     table.element_size(), sms=sms,
                                     blocks_per_sm=blocks_per_sm, n_split=n_split)


def _check_shapes(table, indices) -> None:
    """Validates the reference contract."""
    if table.ndim != 2 or indices.ndim != 2:
        raise ValueError(
            f"table must be (rows, dim) and indices (batch, bag), got "
            f"{tuple(table.shape)} / {tuple(indices.shape)}"
        )
    if table.shape[1] % COLS != 0:
        raise ValueError(f"dim={table.shape[1]} must be a multiple of {COLS}")


def embedding_bag_cuda(
    table: torch.Tensor,    # (rows, dim)
    indices: torch.Tensor,  # (batch, bag) int32, -1 padding
    *,
    n_split: int | None = None,
) -> torch.Tensor:
    """``embedding_bag_pallas`` counterpart (no autograd; see ops).

    ``out[b] = Σ_k table[indices[b, k]]`` over ``indices >= 0``; an index
    at or past ``rows`` reads the last row, as the plain version clamps.
    Returns ``(batch, dim)`` in the table dtype, summed in float32.
    ``n_split`` forces the kernel's split of each bag's positions (1 to
    :data:`MAX_SPLIT`); on CPU tensors it selects
    ``kernels.ref.embedding_bag_split_ref``, the plain version of that
    split.
    """
    _check_shapes(table, indices)
    if n_split is not None:
        _check_n_split(n_split)
    tensors = (table, indices)
    if all(t.device.type == "cpu" for t in tensors):
        if n_split is None:
            return _ref.embedding_bag_ref(table, indices)
        return _ref.embedding_bag_split_ref(table, indices, n_split)
    device = table.device
    if device.type != "cuda" or indices.device != device:
        raise ValueError(
            f"table and indices must share one device, got "
            f"{[str(t.device) for t in tensors]}"
        )
    if table.dtype not in _DTYPE_CODE:
        raise TypeError(f"table dtype {table.dtype} not in {list(_DTYPE_CODE)}")
    if indices.dtype != torch.int32:
        raise TypeError(f"indices dtype {indices.dtype} must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("table and indices must be contiguous")
    if table.data_ptr() % _ALIGN != 0:
        raise ValueError(f"table data must be {_ALIGN}-byte aligned")
    rows, dim = table.shape
    batch, bag = indices.shape
    if rows == 0:
        raise ValueError("table holds no rows")
    out = torch.empty((batch, dim), dtype=table.dtype, device=device)
    if batch == 0:
        return out
    plan = embedding_bag_device_plan(table, indices, n_split)
    lib = load_embedding_bag()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.embedding_bag_launch(
            table.data_ptr(), indices.data_ptr(), out.data_ptr(),
            rows, dim, batch, bag, _DTYPE_CODE[table.dtype],
            plan.n_split, plan.bags_per_block, plan.block, stream,
        )
    if err != 0:
        msg = lib.embedding_bag_error_string(err).decode()
        raise KernelError(f"embedding_bag kernel launch failed: {msg} ({err})")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
