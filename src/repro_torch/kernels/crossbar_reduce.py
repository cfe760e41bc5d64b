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
output.  The kernel's design follows from that: one CUDA block per query
block walks its own tile schedule (a loop in place of the TPU's
sequential grid axis), reads each tile once with neighbouring threads on
neighbouring columns, keeps the q partial sums in registers, takes the
READ path (one row, no MAC) when the block's bitmap has at most one
active wordline, and writes the output once.

On a CPU tensor the wrapper runs the plain version in
:mod:`repro_torch.kernels.ref`; on a CUDA tensor it launches the kernel
or raises.  ``crossbar_reduce_cuda.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import load_crossbar

#: q_block values the kernel is instantiated for (the flat layout is q=1)
Q_BLOCKS = (1, 2, 4, 8, 16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024  # static-launch shared memory without opt-in


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
) -> torch.Tensor:
    """``crossbar_reduce_pallas`` counterpart (no autograd; see ops).

    3-D bitmaps give the flat ``(batch, dim)`` reduction, 4-D bitmaps the
    query-blocked ``(nb * q_block, dim)`` one in block-major query order.
    ``dynamic_switch`` selects the READ path for slots with at most one
    active wordline; it never changes the values.
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
    if q_block not in Q_BLOCKS:
        raise ValueError(f"q_block={q_block} not in {Q_BLOCKS}")
    num_tiles, tile_rows, dim = image.shape
    if 4 * q_block * tile_rows > _SMEM_LIMIT:
        raise ValueError(
            f"q_block*tile_rows={q_block * tile_rows} bitmap exceeds the "
            f"kernel's {_SMEM_LIMIT} B of shared memory"
        )
    if num_tiles == 0:
        raise ValueError("image holds no tiles")
    nb, max_tiles = tile_ids.shape
    out = torch.empty((nb * q_block, dim), dtype=image.dtype, device=device)
    if nb == 0:
        return out
    lib = load_crossbar()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.crossbar_reduce_launch(
            image.data_ptr(), tile_ids.data_ptr(), bitmaps.data_ptr(),
            out.data_ptr(), num_tiles, tile_rows, dim, nb, max_tiles,
            q_block, _DTYPE_CODE[image.dtype], int(bool(dynamic_switch)),
            stream,
        )
    if err != 0:
        msg = lib.crossbar_error_string(err).decode()
        raise RuntimeError(f"crossbar_reduce kernel launch failed: {msg} ({err})")
    crossbar_reduce_cuda.launches += 1
    return out


crossbar_reduce_cuda.launches = 0
