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
    return _crossbar_partial(image, tile_ids, bitmaps).to(image.dtype)


def _crossbar_partial(image, tile_ids, bitmaps) -> torch.Tensor:
    """The f32 ``(nb * q_block, dim)`` sum over the given slots."""
    nb, _, q_block, _ = bitmaps.shape
    num_tiles, _, dim = image.shape
    tiles = image[tile_ids.long().clamp(0, num_tiles - 1)].float()   # (nb,S,R,D)
    part = torch.einsum("nskr,nsrd->nskd", bitmaps.float(), tiles)
    part = part * (tile_ids >= 0)[..., None, None]
    return part.sum(dim=1).reshape(nb * q_block, dim)


def crossbar_reduce_ref(
    image: torch.Tensor,     # (num_tiles, tile_rows, dim)
    tile_ids: torch.Tensor,  # (batch, max_tiles) int32, -1 padding
    bitmaps: torch.Tensor,   # (batch, max_tiles, tile_rows) 0/1
) -> torch.Tensor:
    """Flat reduction: out[b] = sum_s bitmaps[b, s] @ image[tile_ids[b, s]].

    The flat layout is the blocked one at ``q_block=1``.
    """
    return crossbar_reduce_blocked_ref(image, tile_ids, bitmaps[:, :, None, :])


def crossbar_row_widths(tile_ids: torch.Tensor) -> torch.Tensor:
    """Each schedule row's width: one past its last non-padding slot (0
    for a row of padding).  Every slot at or past it is padding."""
    nb, S = tile_ids.shape
    if S == 0:
        return torch.zeros(nb, dtype=torch.int64, device=tile_ids.device)
    pos = torch.arange(1, S + 1, device=tile_ids.device)
    return (pos * (tile_ids >= 0)).amax(dim=1)


def crossbar_slot_ranges(width: int, n_split: int) -> list[tuple[int, int]]:
    """The crossbar kernel's split rule: split ``i`` of a query block whose
    row is ``width`` slots wide (:func:`crossbar_row_widths`) takes the
    contiguous slots ``[i*width // n_split, (i+1)*width // n_split)``.
    Every slot falls in exactly one range, in order; no range is empty
    while ``n_split <= width``."""
    return [(i * width // n_split, (i + 1) * width // n_split) for i in range(n_split)]


def crossbar_reduce_split_ref(
    image: torch.Tensor,     # (num_tiles, tile_rows, dim)
    tile_ids: torch.Tensor,  # (nb, max_tiles) int32, -1 padding
    bitmaps: torch.Tensor,   # (nb, max_tiles, q_block, tile_rows) or flat 3-D
    n_split: int,
) -> torch.Tensor:
    """:func:`crossbar_reduce_blocked_ref` (or, for 3-D bitmaps,
    :func:`crossbar_reduce_ref`) as the CUDA kernel divides it: in each
    row, each range of :func:`crossbar_slot_ranges` over the row's width
    gives an f32 partial, and the partials are added in rank order (split
    0 first) before the cast to the image dtype.  An empty range adds
    nothing."""
    bm = bitmaps[:, :, None, :] if bitmaps.ndim == 3 else bitmaps
    nb, S, q_block, _ = bm.shape
    width = crossbar_row_widths(tile_ids)[:, None]
    slot = torch.arange(S, device=tile_ids.device)[None, :]
    out = torch.zeros((nb * q_block, image.shape[2]), dtype=torch.float32,
                      device=image.device)
    for i in range(n_split):
        lo, hi = i * width // n_split, (i + 1) * width // n_split
        ids = torch.where((slot >= lo) & (slot < hi), tile_ids, -1)
        if bool((ids >= 0).any()):
            out = out + _crossbar_partial(image, ids, bm)
    return out.to(image.dtype)


def embedding_bag_ref(
    table: torch.Tensor,    # (rows, dim)
    indices: torch.Tensor,  # (batch, bag) int, -1 padding
) -> torch.Tensor:
    """Padded embedding bag: out[b] = sum_k table[indices[b, k]].

    Padding (``indices < 0``) contributes 0; an index at or past ``rows``
    reads the last row (clamped, as the JAX oracle clamps).  Rows are
    summed in float32 and the result is cast to the table dtype.
    """
    return _embedding_bag_partial(table, indices).to(table.dtype)


def onehot_matmul_ref(onehot: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """Oracle for the one-hot matmul micro-kernel: the product in float32,
    cast to ``dense``'s dtype."""
    return (onehot.float() @ dense.float()).to(dense.dtype)


def _embedding_bag_partial(table, indices) -> torch.Tensor:
    """The f32 ``(batch, dim)`` sum over the given positions."""
    rows = table.shape[0]
    take = table[indices.long().clamp(0, rows - 1)].float()       # (B, K, D)
    return (take * (indices >= 0)[..., None]).sum(dim=1)


def embedding_bag_k_ranges(K: int, n_split: int) -> list[tuple[int, int]]:
    """The embedding-bag kernel's split rule: split ``i`` of a bag of
    ``K`` positions takes the contiguous positions ``[i*K // n_split,
    (i+1)*K // n_split)``, padding or not.  Every position falls in exactly
    one range, in order; no range is empty while ``n_split <= K``."""
    return [(i * K // n_split, (i + 1) * K // n_split) for i in range(n_split)]


def embedding_bag_split_ref(
    table: torch.Tensor,    # (rows, dim)
    indices: torch.Tensor,  # (batch, bag) int, -1 padding
    n_split: int,
) -> torch.Tensor:
    """:func:`embedding_bag_ref` as the CUDA kernel divides it: each range
    of :func:`embedding_bag_k_ranges` gives an f32 partial, and the
    partials are added in split order (split 0 first) before the cast to
    the table dtype."""
    out = torch.zeros((indices.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for lo, hi in embedding_bag_k_ranges(indices.shape[1], n_split):
        out = out + _embedding_bag_partial(table, indices[:, lo:hi])
    return out.to(table.dtype)


def fused_decode_attention_ref(q, k_q, k_s, v_q, v_s, length, *, dtype=torch.float32):
    """Cache half of one decode step's attention over an int8 K/V cache:
    dequantize the whole cache and run a masked softmax in one shot.

    q (b, kvh, g, hd); k_q, v_q (b, S, kvh, hd) int8; k_s, v_s (b, S, kvh);
    length a 0-d int tensor (positions ``>= length`` are masked to -1e30,
    never -inf, so ``length = 0`` gives ``m = -1e30``, ``l = S`` and
    ``out = Σ v``).  Returns the unnormalized ``out`` (b, kvh, g, hd) f32,
    the row max ``m`` and the denominator ``l`` (b, kvh, g) f32.
    ``dtype=torch.float64`` computes (and returns) all of it in f64: a
    reference free of the f32 version's own rounding.
    """
    b, S, kvh, hd = k_q.shape
    k = k_q.to(dtype) * k_s.to(dtype)[..., None]
    v = v_q.to(dtype) * v_s.to(dtype)[..., None]
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bkgd,btkd->bkgt", q.to(dtype), k) * scale
    mask = torch.arange(S, device=k_q.device)[None, None, None, :] < length
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    w = torch.exp(s - m[..., None])
    l = w.sum(dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", w, v)
    return out, m, l


DECODE_CHUNK = 64  # cache positions per chunk of the CUDA flash-decode kernel


def decode_split_ranges(length: int, S: int, n_split: int) -> list[tuple[int, int]]:
    """The flash-decode kernel's split rule: the position ranges of the
    splits that do work, in merge order.

    The kernel visits ``min(length, S)`` positions (all ``S`` at
    ``length <= 0``, where every position is masked and weighs 1), in
    ``ceil(visit / 64)`` chunks; split ``i`` takes the contiguous chunks
    ``[i * per, (i + 1) * per)`` with ``per = ceil(n_chunks / n_split)``,
    and a split whose range is empty does nothing.
    """
    visit = S if length <= 0 else min(length, S)
    n_chunks = -(-visit // DECODE_CHUNK)
    per = -(-n_chunks // n_split)
    return [(c * DECODE_CHUNK, min((c + per) * DECODE_CHUNK, S))
            for c in range(0, n_chunks, per)]


def split_bf16(x: torch.Tensor, terms: int) -> list[torch.Tensor]:
    """``x`` (f32) as ``terms`` bf16 tensors whose f32 sum approximates
    it: each term is the bf16 rounding of what the earlier ones left.
    Three terms hold an f32 value to about 2^-24 of its size."""
    out, rest = [], x.float()
    for _ in range(terms):
        t = rest.to(torch.bfloat16)
        out.append(t)
        rest = rest - t.float()
    return out


def _decode_partial(q, k_q, k_s, v_q, v_s, length, lo, hi, tensor_core):
    """``(out, m, l)`` of one split over cache positions ``[lo, hi)``."""
    hd = k_q.shape[-1]
    scale = 1.0 / (hd ** 0.5)
    kq, ks = k_q[:, lo:hi].float(), k_s[:, lo:hi].float()
    vq, vs = v_q[:, lo:hi].float(), v_s[:, lo:hi].float()
    if tensor_core:
        # bf16 terms of q times the exact int8 entries, summed in f32;
        # the per-position scale multiplies the f32 score after the product
        terms = [q] if q.dtype == torch.bfloat16 else split_bf16(q, 3)
        dot = sum(torch.einsum("bkgd,btkd->bkgt", t.float(), kq) for t in terms)
        s = dot * ks.permute(0, 2, 1)[:, :, None, :] * scale
    else:
        s = torch.einsum("bkgd,btkd->bkgt", q.float(), kq * ks[..., None]) * scale
    pos = torch.arange(lo, hi, device=k_q.device)[None, None, None, :]
    s = torch.where(pos < length, s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    w = torch.exp(s - m[..., None])
    l = w.sum(dim=-1)
    if tensor_core:
        # v's scale folded into the weights, which enter as 2 bf16 terms
        wv = w * vs.permute(0, 2, 1)[:, :, None, :]
        out = sum(torch.einsum("bkgt,btkd->bkgd", t.float(), vq) for t in split_bf16(wv, 2))
    else:
        out = torch.einsum("bkgt,btkd->bkgd", w, vq * vs[..., None])
    return out, m, l


def fused_decode_attention_split_ref(q, k_q, k_s, v_q, v_s, length, n_split,
                                     *, tensor_core=False):
    """:func:`fused_decode_attention_ref` as the CUDA kernel divides it:
    the splits of :func:`decode_split_ranges` each give a partial
    ``(out, m, l)``, merged in a fixed order (split 0 first) with
    ``M = max m_i``, ``l = Σ l_i exp(m_i - M)``, ``out = Σ out_i exp(m_i - M)``.

    ``tensor_core=True`` also repeats the kernel's tensor-core
    arithmetic: int8 K and V enter the products unscaled (they are exact
    in bf16); q enters as one bf16 term if it is bf16, else as 3 (hi,
    mid, lo); scores are summed in f32 and scaled by ``k_s`` and
    ``1/sqrt(hd)`` after the product; ``l`` sums the unscaled f32
    weights; the weights times ``v_s`` enter PV as 2 bf16 terms.
    ``length`` is read on the host here; the kernel reads it on the device.
    """
    S = k_q.shape[1]
    parts = [_decode_partial(q, k_q, k_s, v_q, v_s, length, lo, hi, tensor_core)
             for lo, hi in decode_split_ranges(int(length), S, n_split)]
    big_m = parts[0][1]
    for _, m_i, _ in parts[1:]:
        big_m = torch.maximum(big_m, m_i)
    out = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for out_i, m_i, l_i in parts:
        c = torch.exp(m_i - big_m)
        l = l + l_i * c
        out = out + out_i * c[..., None]
    return out, big_m, l
