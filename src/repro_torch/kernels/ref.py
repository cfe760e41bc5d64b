"""Plain PyTorch versions of the port's kernels.

Each ``<kernel>_ref`` takes the kernel's arguments and returns its output
(same shapes, same dtype), built only from torch ops.  The CPU path of
every wrapper runs them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""

from __future__ import annotations

import torch


def crossbar_reduce_blocked_ref(
    image: torch.Tensor,     # (num_tiles, tile_rows, dim)
    tile_ids: torch.Tensor,  # (nb, max_tiles) int32, -1 padding — per BLOCK
    bitmaps: torch.Tensor,   # (nb, max_tiles, q_block, tile_rows) 0/1
) -> torch.Tensor:
    """Query-blocked reduction, ``(nb * q_block, dim)`` block-major.

    out[n*q+k] = sum_s bitmaps[n, s, k] @ image[tile_ids[n, s]]  (padding
    slots contribute 0).  Each slot's product is formed in float32, the
    slots are summed in float32 and the result is cast to the image dtype.
    """
    nb, _, q_block, _ = bitmaps.shape
    num_tiles, _, dim = image.shape
    tiles = image[tile_ids.long().clamp(0, num_tiles - 1)].float()   # (nb,S,R,D)
    part = torch.einsum("nskr,nsrd->nskd", bitmaps.float(), tiles)
    part = part * (tile_ids >= 0)[..., None, None]
    return part.sum(dim=1).reshape(nb * q_block, dim).to(image.dtype)


def crossbar_reduce_ref(
    image: torch.Tensor,     # (num_tiles, tile_rows, dim)
    tile_ids: torch.Tensor,  # (batch, max_tiles) int32, -1 padding
    bitmaps: torch.Tensor,   # (batch, max_tiles, tile_rows) 0/1
) -> torch.Tensor:
    """Flat reduction: out[b] = sum_s bitmaps[b, s] @ image[tile_ids[b, s]].

    The flat layout is the blocked one at ``q_block=1``.
    """
    return crossbar_reduce_blocked_ref(image, tile_ids, bitmaps[:, :, None, :])
