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


def embedding_bag_ref(
    table: torch.Tensor,    # (rows, dim)
    indices: torch.Tensor,  # (batch, bag) int, -1 padding
) -> torch.Tensor:
    """Padded embedding bag: out[b] = sum_k table[indices[b, k]].

    Padding (``indices < 0``) contributes 0; an index at or past ``rows``
    reads the last row (clamped, as the JAX oracle clamps).  Rows are
    summed in float32 and the result is cast to the table dtype.
    """
    rows = table.shape[0]
    take = table[indices.long().clamp(0, rows - 1)].float()       # (B, K, D)
    return (take * (indices >= 0)[..., None]).sum(dim=1).to(table.dtype)


def fused_decode_attention_ref(q, k_q, k_s, v_q, v_s, length):
    """Cache half of one decode step's attention over an int8 K/V cache:
    dequantize the whole cache and run a masked softmax in one shot.

    q (b, kvh, g, hd); k_q, v_q (b, S, kvh, hd) int8; k_s, v_s (b, S, kvh);
    length a 0-d int tensor (positions ``>= length`` are masked to -1e30,
    never -inf, so ``length = 0`` gives ``m = -1e30``, ``l = S`` and
    ``out = Σ v``).  Returns the unnormalized ``out`` (b, kvh, g, hd) f32,
    the row max ``m`` and the denominator ``l`` (b, kvh, g) f32.
    """
    b, S, kvh, hd = k_q.shape
    k = k_q.float() * k_s.float()[..., None]
    v = v_q.float() * v_s.float()[..., None]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k) * scale
    mask = torch.arange(S, device=k_q.device)[None, None, None, :] < length
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    w = torch.exp(s - m[..., None])
    l = w.sum(dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, v)
    return out, m, l
