"""Differentiable crossbar reductions (``torch.autograd.Function``).

The port of ``repro.kernels.ops``' ``crossbar_reduce`` and
``crossbar_reduce_blocked``.  The forward is the CUDA kernel (the plain
version on CPU tensors); the backward is the transposed one-hot scatter
with ``index_add_`` — the JAX package's backward is plain XLA too, so no
backward kernel is due.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.crossbar_reduce import crossbar_reduce_cuda


class _CrossbarReduce(torch.autograd.Function):
    """One Function for both layouts: flat bitmaps are the blocked ones at
    ``q_block=1`` (the kernel dispatches on the bitmap rank)."""

    @staticmethod
    def forward(ctx, image, tile_ids, bitmaps, dynamic_switch):
        ctx.save_for_backward(tile_ids, bitmaps)
        ctx.image_shape = image.shape
        ctx.image_dtype = image.dtype
        return crossbar_reduce_cuda(
            image, tile_ids, bitmaps, dynamic_switch=dynamic_switch
        )

    @staticmethod
    def backward(ctx, g):
        tile_ids, bitmaps = ctx.saved_tensors
        if bitmaps.ndim == 3:
            bitmaps = bitmaps[:, :, None, :]
        num_tiles, tile_rows, dim = ctx.image_shape
        nb, _, q_block, _ = bitmaps.shape
        gq = g.reshape(nb, q_block, dim).float()
        # d_image[t] += Σ_{n,s: ids[n,s]==t} Σ_k bitmaps[n,s,k]^T ⊗ g[n,k]
        valid = tile_ids >= 0
        outer = torch.einsum(
            "skr,skd->srd", bitmaps[valid].float(),
            gq[:, None].expand(-1, tile_ids.shape[1], -1, -1)[valid],
        )
        d_image = torch.zeros(
            (num_tiles, tile_rows, dim), dtype=torch.float32, device=g.device
        )
        d_image.index_add_(0, tile_ids[valid].long(), outer)
        return d_image.to(ctx.image_dtype), None, None, None


def crossbar_reduce(image, tile_ids, bitmaps, dynamic_switch: bool = True):
    """out[b] = Σ_s bitmaps[b,s] @ image[tile_ids[b,s]]  (kernel forward).

    Args:
      image: (num_tiles, tile_rows, dim) permuted/replicated table image.
      tile_ids: (batch, max_tiles) int32, -1 padded.
      bitmaps: (batch, max_tiles, tile_rows) 0/1 activation masks.
      dynamic_switch: take the READ path for popcount<=1 tiles (§III-D).

    Returns:
      (batch, dim) reduced embeddings, image dtype; differentiable in image.
    """
    return _CrossbarReduce.apply(image, tile_ids, bitmaps, dynamic_switch)


def crossbar_reduce_blocked(image, tile_ids, bitmaps, dynamic_switch: bool = True):
    """Query-blocked reduction: out[n*q+k] = Σ_s bitmaps[n,s,k] @ image[tile_ids[n,s]].

    Args:
      image: (num_tiles, tile_rows, dim) permuted/replicated table image.
      tile_ids: (nb, max_tiles) int32, -1 padded — the block's shared
        tile schedule (see reduction.block_compiled_queries).
      bitmaps: (nb, max_tiles, q_block, tile_rows) 0/1 activation masks.
      dynamic_switch: READ path when the block's popcount <= 1 (§III-D).

    Returns:
      (nb * q_block, dim) reduced embeddings in block-major query order.
    """
    return _CrossbarReduce.apply(image, tile_ids, bitmaps, dynamic_switch)
