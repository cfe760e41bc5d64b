"""GQA self-attention: full-sequence (train and prefill) and one-token
decode over bf16 and int8 KV caches.

The port of ``repro.models.attention`` for the dense family.  Layouts are
JAX's: activations ``(b, s, d_model)``, Q/K/V ``(b, s, heads, head_dim)``,
a layer's cache ``(b, max_seq, kv_heads, head_dim)``; GQA groups query
heads by einsum reshape, with no repeated K/V.  The cache length is a
0-d int32 tensor on the cache's device and is never read on the host.

``decode_attention_readonly`` with ``kv_scale`` (an int8 cache) computes
the cache half of the attention with the CUDA flash-decode kernel
(:func:`repro_torch.kernels.decode_attention.fused_decode_attention_cuda`,
the plain version on CPU tensors) and merges the new token's own score
into its ``(out, m, l)`` in plain torch.  The bf16 branch stays plain
torch, as in JAX.

``self_attention`` and ``chunked_self_attention`` compute the reference's
plain-``jnp`` arithmetic in plain torch: float32 scores scaled by
``1/sqrt(head_dim)``, the ``-1e30`` causal (and sliding-window) mask, the
softmax in float32 cast to ``x.dtype`` before the value product; the
chunked form runs the online softmax in float32 over ``(q_chunk,
k_chunk)`` blocks and recomputes each block in backward.
``cross_attention`` (the vlm family) attends from the text to the
encoder's (image) embeddings with the same float32 scores and softmax,
in query chunks of 512 when the sequence is a longer multiple of 512,
scaled by ``tanh(gate)`` (zero at init).

Inside an ``activation_sharding_ctx`` (:mod:`repro_torch.dist.sharding`)
``self_attention`` lays its float32 scores out by ``_SCORE_SHARDINGS``, as
the reference does, and the GQA einsums run on each rank's own shard of
that layout (``local_map``; DTensor cannot shard their views over the
heads): its batch slice, and its kv heads or its slice of every kv
head's q-groups, so the scores are made where they are laid out and
never gathered; ``chunked_self_attention``'s online softmax runs on the
same shards.  On a mesh the decode functions write each rank's shard of
the cache (``write_at``) and attend on its shards: a cache whose sequence
the mesh splits (``cache_specs`` splits it where the kv heads do not
divide the model axis) is never gathered; its softmax's max, denominator
and value product are all-reduced instead
(:func:`attention_over_seq_shards`, and ``_flash_decode_over_seq_shards``
around the int8 kernel).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import (
    _current, logical_to_spec, maybe_shard_any, place, replicate_like, sanitize_spec, shard_index,
    to_placements,
)
from repro_torch.kernels import decode_attention as kda
from repro_torch.models.layers import Params, dense_init, on_device
from repro_torch.models.rope import apply_rope

_KERNEL_BLOCK_S = 512  # the TPU kernel's default S tile, checked by the wrapper

# candidate shardings for the (b, kv_heads, g, s_q, s_k) score tensor:
# prefer head parallelism (kv heads, then q-groups).  When neither head
# count divides TP the scores stay batch-sharded — long sequences avoid
# the quadratic buffer entirely via chunked_self_attention instead.
_SCORE_SHARDINGS = (
    ("batch", "kv_heads", None, None, None),
    ("batch", None, "qgroups", None, None),
)


def init_attention(generator: torch.Generator, d_model, num_heads, kv_heads, head_dim,
                   dtype, *, use_bias=False, device=None) -> Params:
    device = on_device(generator, device)
    p = {
        "wq": dense_init(generator, d_model, num_heads * head_dim, dtype, device=device),
        "wk": dense_init(generator, d_model, kv_heads * head_dim, dtype, device=device),
        "wv": dense_init(generator, d_model, kv_heads * head_dim, dtype, device=device),
        "wo": dense_init(generator, num_heads * head_dim, d_model, dtype, scale=0.5,
                         device=device),
    }
    if use_bias:
        p["bq"] = torch.zeros((num_heads * head_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv_heads * head_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv_heads * head_dim,), dtype=dtype, device=device)
    return p


def _project(p, x, num_heads, kv_heads, head_dim):
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (
        _split_heads(q, num_heads, head_dim),
        _split_heads(k, kv_heads, head_dim),
        _split_heads(v, kv_heads, head_dim),
    )


def _split_heads(t, heads: int, head_dim: int):
    """``(b, s, heads·head_dim)`` → ``(b, s, heads, head_dim)``.  In an
    activation context a split of the last dim that the head count does
    not divide (2 kv heads over 4 TP ranks) is gathered first: DTensor
    cannot view it as whole heads."""
    from torch.distributed.tensor import Replicate, Shard

    b, s, _ = t.shape
    _, mesh = _current()
    if mesh is not None and hasattr(t, "placements"):
        dims = [i for i, p in enumerate(t.placements) if p == Shard(2)]
        if heads % math.prod(mesh.size(i) for i in dims):
            t = place(t, mesh, [Replicate() if i in dims else p
                                for i, p in enumerate(t.placements)])
    return t.reshape(b, s, heads, head_dim)


def _score_layout(b: int, kvh: int, g: int):
    """``(mesh, placements)`` of the ``(b, kvh, g, s, t)`` scores in the
    activation context: the first of ``_SCORE_SHARDINGS`` that survives
    sanitization intact (as ``maybe_shard_any`` picks it), else the batch
    alone; ``(None, None)`` outside a context."""
    rules, mesh = _current()
    if mesh is None:
        return None, None
    for axes in _SCORE_SHARDINGS:
        spec = logical_to_spec(axes, rules)
        if sanitize_spec(spec, (b, kvh, g, 1, 1), mesh) == spec:
            return mesh, to_placements(spec, mesh)
    spec = logical_to_spec(("batch", None, None, None, None), rules)
    return mesh, to_placements(sanitize_spec(spec, (b, kvh, g, 1, 1), mesh), mesh)


def _operand_layout(sp, head_dim: int):
    """Placements of q, k or v (heads on ``head_dim``) for scores laid out
    by ``sp``, and of their gradients: the batch and the kv-head splits
    kept, replicated where the ranks split the q-groups, whose gradients
    are then partial sums."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    pl = tuple(Shard(0) if p == Shard(0) else Shard(head_dim) if p == Shard(1) else Replicate()
               for p in sp)
    grad = tuple(Partial() if s == Shard(2) else p for p, s in zip(pl, sp))
    return pl, grad


def _groups(mesh, sp, g: int):
    """This rank's ``[lo, hi)`` of the q-groups under ``sp``."""
    from torch.distributed.tensor import Shard

    index, count = shard_index(mesh, [i for i, p in enumerate(sp) if p == Shard(2)])
    return index * g // count, (index + 1) * g // count


def _gqa_scores(q, k):
    """q: (b,s,H,d), k: (b,t,Hkv,d) → scores (b, Hkv, q_per_kv, s, t).  In
    an activation context each rank computes its shard of the scores'
    layout (``_score_layout``) from its shards of q and k."""
    from torch.distributed.tensor.experimental import local_map

    b, _, H, _ = q.shape
    kvh = k.shape[2]
    mesh, sp = _score_layout(b, kvh, H // kvh)
    if mesh is None:
        return _gqa_scores_local(q, k)
    pl, grad = _operand_layout(sp, 2)
    fn = functools.partial(_gqa_scores_local, groups=_groups(mesh, sp, H // kvh))
    return local_map(fn, out_placements=sp, in_placements=(pl, pl),
                     in_grad_placements=(grad, grad))(place(q, mesh, pl), place(k, mesh, pl))


def _gqa_scores_local(q, k, groups=None):
    b, s, H, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, H // kvh, d)
    if groups is not None:
        qg = qg[:, :, :, groups[0]:groups[1]]
    return torch.einsum("bskgd,btkd->bkgst", qg, k)


def _gqa_out(attn, v):
    """attn: (b,Hkv,g,s,t), v: (b,t,Hkv,d) → (b,s,H*d); in an activation
    context on each rank's shards, as ``_gqa_scores``, and gathered over
    the q-groups where the ranks split them."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    b, kvh, g, s, _ = attn.shape
    mesh, sp = _score_layout(b, kvh, g)
    if mesh is None:
        return _gqa_out_local(attn, v)
    pl, grad = _operand_layout(sp, 2)
    split_groups = Shard(2) in sp
    # (b, s, H*d) with the kv heads outermost, so a kv-head split is a
    # split of its last dim; a q-group split is gathered from (b, s, kvh, g, d)
    out_pl = [Shard(0) if p == Shard(0) else Shard(2) if p == Shard(1)
              else Shard(3) if p == Shard(2) else Replicate() for p in sp]
    out = local_map(functools.partial(_gqa_out_local, flat=not split_groups),
                    out_placements=out_pl, in_placements=(sp, pl),
                    in_grad_placements=(sp, grad))(place(attn, mesh, sp), place(v, mesh, pl))
    return out if not split_groups else _merge_groups(out, out_pl)


def _merge_groups(out, out_pl):
    """``out`` (b, s, kvh, g, hd) laid out by ``out_pl`` with the q-groups
    split, gathered and flattened to (b, s, kvh·g·hd).  The flatten runs
    on local tensors: DTensor cannot view its gradient, split over the
    flat dim, back into a group split that the ranks do not divide."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate() if p == Shard(3) else p for p in out_pl]
    return local_map(lambda t: t.flatten(2), out_placements=rep, in_placements=(rep,),
                     in_grad_placements=(rep,), redistribute_inputs=True)(out)


def _gqa_out_local(attn, v, flat=True):
    b, kvh, g, s, t = attn.shape
    out = torch.einsum("bkgst,btkd->bskgd", attn, v)
    return out.reshape(b, s, kvh * g * v.shape[-1]) if flat else out


def _causal_mask(qpos, kpos, window: int):
    """``kpos <= qpos`` (and ``kpos > qpos - window`` when ``window``)."""
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def self_attention(
    p: Params,
    x: torch.Tensor,                 # (b, s, d_model)
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    positions: Optional[torch.Tensor] = None,
    rope_theta: float = 10_000.0,
    rope_partial: bool = False,
    causal: bool = True,
    window: int = 0,                 # >0 → sliding-window attention
) -> torch.Tensor:
    """Full-sequence GQA attention; materializes the ``(s, s)`` scores."""
    b, s, _ = x.shape
    q, k, v = _project(p, x, num_heads, kv_heads, head_dim)
    if positions is None:
        positions = replicate_like(torch.arange(s, device=x.device)[None, :], x)
    q = apply_rope(q, positions, theta=rope_theta, partial=rope_partial)
    k = apply_rope(k, positions, theta=rope_theta, partial=rope_partial)

    scores = maybe_shard_any(_gqa_scores(q, k).float() / math.sqrt(head_dim), _SCORE_SHARDINGS)
    if causal:
        mask = _causal_mask(positions[:, None, None, :, None],
                            positions[:, None, None, None, :], window)
        scores = torch.where(mask, scores, -1e30)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    return _gqa_out(attn, v) @ p["wo"]


def _online_softmax_block(m, l, acc, q_blk, k_blk, v_blk, qp, kp, scale: float,
                          window: int):
    """One key block of the online softmax: ``(m, l, acc)`` updated with the
    scores of ``q_blk (b, qc, kvh, g, d)`` against ``k_blk (b, kc, kvh, d)``."""
    sc = torch.einsum("bqkgd,btkd->bqkgt", q_blk, k_blk) * scale
    mask = _causal_mask(qp[:, :, None, None, None], kp[:, None, None, None, :], window)
    sc = torch.where(mask, sc, -1e30)
    m_new = torch.maximum(m, sc.amax(dim=-1))
    correction = torch.exp(m - m_new)
    w = torch.exp(sc - m_new[..., None])
    l_new = l * correction + w.sum(dim=-1)
    acc_new = acc * correction[..., None] + torch.einsum("bqkgt,btkd->bqkgd", w, v_blk)
    return m_new, l_new, acc_new


def chunked_self_attention(
    p: Params,
    x: torch.Tensor,                 # (b, s, d_model)
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    positions: Optional[torch.Tensor] = None,
    rope_theta: float = 10_000.0,
    rope_partial: bool = False,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
    window: int = 0,
) -> torch.Tensor:
    """Flash-style causal attention: online softmax over key chunks.

    Never materializes the ``(s, s)`` scores: the largest intermediate is
    one ``(q_chunk, k_chunk)`` block per head.  Every key block is visited
    for every query block, in order, as the reference's scan does.  With
    gradients on, each block runs under ``torch.utils.checkpoint``, so
    backward recomputes its scores and the saved memory stays
    O(q_chunk·k_chunk) (the reference's ``jax.checkpoint``).
    """
    b, s, _ = x.shape
    if s % q_chunk or s % k_chunk:
        raise ValueError(f"seq {s} is not a multiple of q_chunk {q_chunk} "
                         f"and k_chunk {k_chunk}")
    q, k, v = _project(p, x, num_heads, kv_heads, head_dim)
    if positions is None:
        positions = replicate_like(torch.arange(s, device=x.device)[None, :], x)
    q = apply_rope(q, positions, theta=rope_theta, partial=rope_partial)
    k = apply_rope(k, positions, theta=rope_theta, partial=rope_partial)
    core = functools.partial(_chunked_core, q_chunk=q_chunk, k_chunk=k_chunk, window=window,
                             scale=1.0 / math.sqrt(head_dim), dtype=x.dtype)
    return _on_score_shards(core, q, k, v, positions) @ p["wo"]


def _on_score_shards(core, q, k, v, positions):
    """``core(q, k, v, positions)`` → ``(b, s, H*hd)``; in an activation
    context on each rank's shard of the scores' layout (``_score_layout``:
    its batch slice and its kv heads or its q-groups), as ``_gqa_scores``
    and ``_gqa_out`` run, so no score block is ever gathered."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    b, _, H, _ = q.shape
    kvh = k.shape[2]
    mesh, sp = _score_layout(b, kvh, H // kvh)
    if mesh is None:
        return core(q, k, v, positions)
    pl, grad = _operand_layout(sp, 2)
    split_groups = Shard(2) in sp
    # positions (1, s) are every rank's; (b, s) split with the batch
    pos_pl = tuple(Shard(0) if p == Shard(0) and positions.shape[0] > 1 else Replicate()
                   for p in sp)
    out_pl = [Shard(0) if p == Shard(0) else Shard(2) if p == Shard(1)
              else Shard(3) if p == Shard(2) else Replicate() for p in sp]
    fn = functools.partial(core, groups=_groups(mesh, sp, H // kvh), flat=not split_groups)
    out = local_map(fn, out_placements=out_pl, in_placements=(pl, pl, pl, pos_pl),
                    in_grad_placements=(grad, grad, grad, pos_pl), redistribute_inputs=True)(
        place(q, mesh, pl), place(k, mesh, pl), place(v, mesh, pl),
        replicate_like(positions, q) if not hasattr(positions, "placements") else positions)
    return out if not split_groups else _merge_groups(out, out_pl)


def _chunked_core(q, k, v, positions, *, q_chunk: int, k_chunk: int, window: int,
                  scale: float, dtype, groups=None, flat=True):
    """The online softmax of ``chunked_self_attention`` over ``q`` (b, s, H,
    hd) and ``k``/``v`` (b, s, kvh, hd), the q-groups ``[lo, hi)`` of each
    kv head when ``groups``: ``(b, s, kvh·g·hd)``, or ``(b, s, kvh, g,
    hd)`` unless ``flat``."""
    b, s, H, head_dim = q.shape
    kvh = k.shape[2]
    g = H // kvh
    qg = q.reshape(b, s, kvh, g, head_dim)
    if groups is not None:
        qg = qg[:, :, :, groups[0]:groups[1]]
        g = groups[1] - groups[0]
    positions = positions.expand(b, s)
    nq, nk = s // q_chunk, s // k_chunk
    qc = qg.reshape(b, nq, q_chunk, kvh, g, head_dim).float()
    kc = k.reshape(b, nk, k_chunk, kvh, head_dim).float()
    vc = v.reshape(b, nk, k_chunk, kvh, head_dim).float()
    qpos = positions.reshape(b, nq, q_chunk)
    kpos = positions.reshape(b, nk, k_chunk)
    remat = torch.is_grad_enabled()

    outs = []
    for qi in range(nq):
        m = torch.full((b, q_chunk, kvh, g), -1e30, device=q.device)
        l = torch.zeros((b, q_chunk, kvh, g), device=q.device)
        acc = torch.zeros((b, q_chunk, kvh, g, head_dim), device=q.device)
        for ki in range(nk):
            args = (m, l, acc, qc[:, qi], kc[:, ki], vc[:, ki], qpos[:, qi], kpos[:, ki],
                    scale, window)
            if remat:
                m, l, acc = checkpoint(_online_softmax_block, *args, use_reentrant=False)
            else:
                m, l, acc = _online_softmax_block(*args)
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        # accumulate f32, store in x.dtype, as the reference does
        outs.append(out.to(dtype))                        # (b, q_chunk, kvh, g, d)
    out = torch.stack(outs, dim=1).reshape(b, s, kvh, g, head_dim)
    return out.reshape(b, s, kvh * g * head_dim) if flat else out


def _new_qkv(p, x, cache_len, num_heads, kv_heads, head_dim, rope_theta, rope_partial):
    b = x.shape[0]
    pos = cache_len.to(torch.int32).expand(b, 1)
    q, k, v = _project(p, x, num_heads, kv_heads, head_dim)
    q = apply_rope(q, pos, theta=rope_theta, partial=rope_partial)
    k = apply_rope(k, pos, theta=rope_theta, partial=rope_partial)
    return q, k, v


def write_at(cache: torch.Tensor, dim: int, cache_len: torch.Tensor,
             value: torch.Tensor) -> None:
    """Writes ``value`` (extent 1 along ``dim``) into ``cache`` at position
    ``cache_len``, in place (JAX's ``dynamic_update_slice`` builds a new
    array).  The position stays on the device.  Where JAX clamps a write
    past the end silently, this raises: an ``IndexError`` on the CPU, a
    device-side bounds assertion on the card.

    A DTensor cache is written on each rank's own shard: ``value`` laid out
    as the cache (whole along ``dim``), and where the mesh splits ``dim``
    (a sequence-sharded cache) the rank whose slice holds ``cache_len``
    writes it, the others write back what they hold; a write past the end
    of such a cache is dropped, not raised."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(cache, DTensor):
        cache.index_copy_(dim, cache_len.reshape(1).long(), value)
        return
    mesh, pl = cache.device_mesh, cache.placements
    v = place(value, mesh, [Replicate() if p == Shard(dim) else p for p in pl]).to_local()
    local = cache.to_local()
    pos = cache_len.to_local() if isinstance(cache_len, DTensor) else cache_len
    index, count = shard_index(mesh, [i for i, p in enumerate(pl) if p == Shard(dim)])
    n = local.shape[dim]
    pos = pos.reshape(1).long() - index * n
    if count == 1:
        local.index_copy_(dim, pos, v)
        return
    at = pos.clamp(0, n - 1)
    hit = ((pos >= 0) & (pos < n)).reshape([1] * v.dim())
    local.index_copy_(dim, at, torch.where(hit, v, local.index_select(dim, at)))


def decode_attention(
    p: Params,
    x: torch.Tensor,                 # (b, 1, d_model) — one new token
    k_cache: torch.Tensor,           # (b, max_seq, kv_heads, head_dim)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,         # 0-d int32 — tokens already cached
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    rope_theta: float = 10_000.0,
    rope_partial: bool = False,
):
    """One decode step: write K/V at ``cache_len`` (in place), attend over
    the valid prefix.  Returns ``(out (b,1,d_model), k_cache, v_cache)``."""
    q, k, v = _new_qkv(p, x, cache_len, num_heads, kv_heads, head_dim,
                       rope_theta, rope_partial)
    write_at(k_cache, 1, cache_len, k)
    write_at(v_cache, 1, cache_len, v)

    pos = replicate_like(torch.arange(k_cache.shape[1], device=k_cache.device), k_cache)
    if seq_split_dims(k_cache):
        out = attention_over_seq_shards(q, k_cache, v_cache, (pos <= cache_len)[None, :],
                                        x.dtype, 1.0 / math.sqrt(head_dim))
        return out @ p["wo"], k_cache, v_cache
    scores = _gqa_scores(q, k_cache).float() / math.sqrt(head_dim)
    valid = (pos <= cache_len)[None, None, None, None, :]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _gqa_out(attn, v_cache) @ p["wo"]
    return out, k_cache, v_cache


def decode_attention_readonly(
    p: Params,
    x: torch.Tensor,                 # (b, 1, d_model) — one new token
    k_cache: torch.Tensor,           # (b, max_seq, kv_heads, head_dim) READ-ONLY
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,         # 0-d int32
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    rope_theta: float = 10_000.0,
    rope_partial: bool = False,
    kv_scale: Optional[tuple] = None,  # (k_scale, v_scale) (b, max_seq, kvh) for int8 caches
):
    """Decode WITHOUT writing the cache: attends over the valid prefix plus
    the new token's own K/V and returns ``(out, k_new, v_new)``, so the
    caller writes every layer's new K/V in one batched update.

    With ``kv_scale`` (an int8 cache) the cache half runs through the
    flash-decode kernel, which returns its unnormalized ``acc`` with row
    max ``m_c`` and denominator ``l``; the new token's score ``s_n`` is
    merged as ``m = max(m_c, s_n)``, ``out = (acc·e^(m_c−m) + e^(s_n−m)·
    v_new) / (l·e^(m_c−m) + e^(s_n−m))``.  ``k_new``/``v_new`` are
    returned unquantized.
    """
    b = x.shape[0]
    q, k, v = _new_qkv(p, x, cache_len, num_heads, kv_heads, head_dim,
                       rope_theta, rope_partial)
    scores_n = _gqa_scores(q, k).float() / math.sqrt(head_dim)   # (b,kvh,g,1,1)

    if kv_scale is None:
        pos = replicate_like(torch.arange(k_cache.shape[1], device=k_cache.device), k_cache)
        if seq_split_dims(k_cache):
            out = attention_over_seq_shards(q, k_cache, v_cache, (pos < cache_len)[None, :],
                                            x.dtype, 1.0 / math.sqrt(head_dim), new=(k, v))
            return out @ p["wo"], k, v
        scores_c = _gqa_scores(q, k_cache).float() / math.sqrt(head_dim)
        valid = (pos < cache_len)[None, None, None, None, :]
        scores_c = torch.where(valid, scores_c, torch.full_like(scores_c, -1e30))
        m = torch.maximum(scores_c.amax(dim=-1, keepdim=True), scores_n)
        wc = torch.exp(scores_c - m)
        wn = torch.exp(scores_n - m)
        denom = wc.sum(dim=-1, keepdim=True) + wn
        out = (
            _gqa_out((wc / denom).to(x.dtype), v_cache)
            + _gqa_out((wn / denom).to(x.dtype), v)
        ) @ p["wo"]
        return out, k, v

    ks, vs = kv_scale
    g = num_heads // kv_heads
    qg = _unsplit(q, 2).reshape(b, kv_heads, g, head_dim)     # s = 1
    acc, m_c, l_c = _flash_decode(qg, k_cache, ks, v_cache, vs, cache_len.to(torch.int32))
    s_n = scores_n.reshape(b, kv_heads, g)
    m = torch.maximum(m_c, s_n)
    corr = torch.exp(m_c - m)
    wn = torch.exp(s_n - m)
    v_n = v.float().reshape(b, kv_heads, 1, head_dim)
    num = acc * corr[..., None] + wn[..., None] * v_n
    den = l_c * corr + wn
    o = _unsplit((num / den[..., None]).to(x.dtype), 1, 2)    # (b,kvh,g,hd)
    out = o.reshape(b, 1, num_heads * head_dim) @ p["wo"]
    return out, k, v


def _flash_decode(qg, k_cache, ks, v_cache, vs, length):
    """The flash-decode kernel's ``(acc, m, l)`` for ``qg`` (b, kvh, g, hd);
    in an activation context on each rank's shard of the scores' layout
    (its batch slice, and its kv heads or q-groups), or of a
    sequence-split cache (:func:`_flash_decode_over_seq_shards`)
    (``local_map``).  The TPU kernel's S tile, which the wrapper checks, is
    the largest power of two up to 512 that divides the cache it reads."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    def kernel(q, kc, kscale, vc, vscale, n):
        return kda.fused_decode_attention_cuda(q.contiguous(), kc.contiguous(),
                                               kscale.contiguous(), vc.contiguous(),
                                               vscale.contiguous(), n,
                                               block_s=math.gcd(kc.shape[1], _KERNEL_BLOCK_S))

    if seq_split_dims(k_cache):
        return _flash_decode_over_seq_shards(kernel, qg, k_cache, ks, v_cache, vs, length)
    b, kvh, g, _ = qg.shape
    mesh, sp = _score_layout(b, kvh, g)
    if mesh is None:
        return kernel(qg, k_cache, ks, v_cache, vs, length)
    pl, _ = _operand_layout(sp, 2)
    rep = (Replicate(),) * mesh.ndim
    length = length if hasattr(length, "placements") else replicate_like(length, qg)
    return local_map(kernel, out_placements=(sp, sp, sp),
                     in_placements=(sp, pl, pl, pl, pl, rep), redistribute_inputs=True)(
        place(qg, mesh, sp), k_cache, ks, v_cache, vs, length)


def seq_split_dims(cache) -> list:
    """The mesh dims that split the sequence (dim 1) of a ``(b, S, kvh,
    hd)`` cache laid out as a DTensor; ``[]`` otherwise."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(getattr(cache, "placements", ())) if p == Shard(1)]


def _seq_layouts(cache):
    """``(mesh, seq dims, placements of a batch-leading tensor split as the
    cache's batch, placements of the cache)`` for a sequence-split cache."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = cache.device_mesh, tuple(cache.placements)
    batch = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)
    cache_pl = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in pl)
    return mesh, seq_split_dims(cache), batch, cache_pl


def _all_reduce(t, op: str, mesh, dims):
    from torch.distributed import _functional_collectives as funcol

    for d in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
    return t


def attention_over_seq_shards(q, k_cache, v_cache, valid, dtype, scale: float, new=None):
    """One new query ``q`` (b, 1, H, hd) over a cache ``(b, S, kvh, hd)``
    whose sequence the mesh splits: the softmax over the positions where
    ``valid`` ((1 or b, S) bool) holds, and the new token's own ``new =
    (k, v)`` when given, times the values: ``(b, 1, H·hd)``.

    Each rank scores its own positions; the softmax's max and denominator
    and the value product are all-reduced over the splitting mesh dims
    (output-sized: the cache never moves), in the one-device path's
    arithmetic (float32 scores and weights, the weights cast to ``dtype``
    before the value product)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, dims, batch, cache_pl = _seq_layouts(k_cache)
    valid_pl = tuple(Shard(1) if i in dims else p if valid.shape[0] > 1 else Replicate()
                     for i, p in enumerate(batch))

    def local(q, kc, vc, ok, *kv):
        sc = _gqa_scores_local(q, kc).float() * scale                # (b, kvh, g, 1, S_l)
        sc = torch.where(ok[:, None, None, None, :], sc, -1e30)
        m = sc.amax(dim=-1, keepdim=True)
        if kv:
            sn = _gqa_scores_local(q, kv[0]).float() * scale
            m = torch.maximum(m, sn)
        m = _all_reduce(m, "max", mesh, dims)
        w = torch.exp(sc - m)
        den = _all_reduce(w.sum(dim=-1, keepdim=True), "sum", mesh, dims)
        if kv:
            wn = torch.exp(sn - m)
            den = den + wn
        out = _all_reduce(_gqa_out_local((w / den).to(dtype), vc), "sum", mesh, dims)
        if kv:
            out = out + _gqa_out_local((wn / den).to(dtype), kv[1])
        return out

    args = [place(q, mesh, batch), k_cache, v_cache, place(valid, mesh, valid_pl)]
    if new is not None:
        args += [place(t, mesh, batch) for t in new]
    return local_map(local, out_placements=list(batch),
                     in_placements=(batch, cache_pl, cache_pl, valid_pl) + (batch,) * len(
                         args[4:]), redistribute_inputs=True)(*args)


def _flash_decode_over_seq_shards(kernel, qg, k_cache, ks, v_cache, vs, length):
    """The flash-decode kernel on each rank's slice of a sequence-split
    cache (the length made local to the slice), the partial ``(acc, m,
    l)`` merged over the splitting mesh dims: ``m`` the max, ``acc`` and
    ``l`` rescaled to it and summed."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, dims, batch, cache_pl = _seq_layouts(k_cache)
    rep = (Replicate(),) * mesh.ndim
    index, _ = shard_index(mesh, dims)

    def local(q, kc, kscale, vc, vscale, n):
        n_loc = (n - index * kc.shape[1]).clamp(0, kc.shape[1]).to(torch.int32)
        acc, m, l = kernel(q, kc, kscale, vc, vscale, n_loc)
        m_all = _all_reduce(m, "max", mesh, dims)
        c = torch.exp(m - m_all)
        return (_all_reduce(acc * c[..., None], "sum", mesh, dims), m_all,
                _all_reduce(l * c, "sum", mesh, dims))

    length = length if hasattr(length, "placements") else replicate_like(length, qg)
    return local_map(local, out_placements=(batch, batch, batch),
                     in_placements=(batch, cache_pl, cache_pl, cache_pl, cache_pl, rep),
                     redistribute_inputs=True)(
        place(qg, mesh, batch), k_cache, ks, v_cache, vs, length)


def _unsplit(t, *dims: int):
    """``t`` gathered along ``dims`` where a DTensor's ranks split them (the
    heads of q; the kv heads and q-groups of the output, which DTensor may
    split unevenly), so a view can regroup them; any other tensor as it
    is."""
    from torch.distributed.tensor import Replicate, Shard

    split = [Shard(d) for d in dims]
    if not hasattr(t, "placements") or not any(p in split for p in t.placements):
        return t
    return place(t, t.device_mesh, [Replicate() if p in split else p for p in t.placements])


def init_cross_attention(generator: torch.Generator, d_model, num_heads, kv_heads, head_dim,
                         enc_dim, dtype, *, device=None) -> Params:
    device = on_device(generator, device)
    return {
        "wq": dense_init(generator, d_model, num_heads * head_dim, dtype, device=device),
        "wk": dense_init(generator, enc_dim, kv_heads * head_dim, dtype, device=device),
        "wv": dense_init(generator, enc_dim, kv_heads * head_dim, dtype, device=device),
        "wo": dense_init(generator, num_heads * head_dim, d_model, dtype, scale=0.5,
                         device=device),
        # zero-init tanh gate (Llama-vision style)
        "gate": torch.zeros((1,), dtype=dtype, device=device),
    }


def _cross_block(q_blk, k, v, head_dim: int, dtype):
    """One query chunk ``(b, qc, H, hd)`` over all of ``k``/``v``:
    ``(b, qc, H*hd)``."""
    scores = _gqa_scores(q_blk, k).float() / math.sqrt(head_dim)
    attn = torch.softmax(scores, dim=-1).to(dtype)
    return _gqa_out(attn, v)


def cross_attention(
    p: Params,
    x: torch.Tensor,                 # (b, s, d_model)
    enc: torch.Tensor,               # (b, t, enc_dim): image/patch embeddings
    *,
    num_heads: int,
    kv_heads: int,
    head_dim: int,
    q_chunk: int = 512,
) -> torch.Tensor:
    """Gated cross-attention.  When ``s > q_chunk`` and ``s`` is a multiple
    of it, the queries go in chunks, so the score buffer never exceeds
    ``(q_chunk, t)`` a head; with gradients on, each chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``)."""
    b, s, _ = x.shape
    q = _split_heads(x @ p["wq"], num_heads, head_dim)
    k = _split_heads(enc @ p["wk"], kv_heads, head_dim)
    v = _split_heads(enc @ p["wv"], kv_heads, head_dim)
    if s > q_chunk and s % q_chunk == 0:
        remat = torch.is_grad_enabled()
        outs = []
        for i in range(s // q_chunk):
            args = (q[:, i * q_chunk:(i + 1) * q_chunk], k, v, head_dim, x.dtype)
            outs.append(checkpoint(_cross_block, *args, use_reentrant=False) if remat
                        else _cross_block(*args))
        out = torch.cat(outs, dim=1)
    else:
        out = _cross_block(q, k, v, head_dim, x.dtype)
    return torch.tanh(p["gate"]) * (out @ p["wo"])
