"""Decoder LM of every family: parameters, full-sequence forward and the
training loss.

The port of ``repro.models.transformer``:

  dense  — pre-norm GQA attention + (Sw/Ge)GLU MLP blocks;
  moe    — the MLP replaced by a top-k expert layer
           (:mod:`repro_torch.models.moe`), its load-balancing loss
           summed over the layers into ``aux``;
  vlm    — superblocks of ``cross_attn_period`` self-attention blocks and
           one gated cross-attention block over image embeddings ``enc``
           (``layers = {"super": (n_super, period, …), "cross":
           (n_super, …)}``);
  audio  — ``num_codebooks`` embeddings summed at the input and as many
           heads out (``embed_{c}``/``head_{c}``; logits ``(b, K, s, V)``);
  ssm    — xLSTM (:mod:`repro_torch.models.xlstm`): mLSTM blocks with an
           sLSTM block at every ``i % slstm_every == 0``, no FFN
           (``layers = {"slstm": (n_s, …), "mlstm": (n_m, …)}``); from
           ``MLSTM_CHUNK_THRESHOLD`` tokens the mLSTM runs chunkwise;
  hybrid — zamba2: a Mamba2 backbone (:mod:`repro_torch.models.mamba2`)
           with ONE shared attention block applied after every
           ``shared_attn_period`` Mamba2 layers, one set of parameters for
           every application (``layers = {"super": (n_super, period, …),
           "shared_attn", "tail"}``, ``"tail"`` holding the layers past the
           last whole superblock, when there are any).

``init_lm`` keeps JAX's leaf names, nesting and shapes (layer parameters
stacked on leading axes as JAX's ``stack_layers`` does, the vocab padded
to ``cfg.padded_vocab``), so ``convert.lm_params_from_numpy`` and the
checkpoints carry trees across unchanged.  ``forward`` runs the embedding
gather, the blocks, the final norm and the head(s); sequences of at least
``CHUNKED_ATTN_THRESHOLD`` tokens take ``chunked_self_attention`` (the
hybrid's shared attention then with a window of 4,096).  JAX's
``lax.scan`` over stacked layers is a Python loop over layer views;
``remat=True`` wraps each block (each vlm, xlstm and zamba superblock;
each mLSTM block when there is no sLSTM) in ``torch.utils.checkpoint``
where JAX wraps it in ``jax.checkpoint``.  One-token decode is
``repro_torch.serve.decode``.

Inside an ``activation_sharding_ctx`` (:mod:`repro_torch.dist.sharding`)
the activations are laid out as the reference constrains them (after the
embedding, twice in each dense/moe/audio block, on the logits), with
parameters and batch as DTensors; outside one every constraint returns
its argument and the forward is the one-device forward, bit for bit.  On
a mesh the embedding is a vocab-parallel lookup (``_embed``).

One deliberate difference: at ``slstm_every = 0`` JAX's ``init_lm``
raises (``stack_layers`` of the empty sLSTM list); the port leaves the
``"slstm"`` key out, the tree the reference's forward and decode read in
that case.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import _current, maybe_shard, place, replicate_like, shard_index
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, xlstm
from repro_torch.models.layers import (
    Params,
    tree_leaves,
    apply_mlp,
    apply_norm,
    dense_init,
    embed_init,
    init_mlp,
    init_norm,
    layer_slice,
    on_device,
    tree_map,
)
from repro_torch.models.moe import apply_moe, apply_moe_shardmap, init_moe

def _init_block(generator: torch.Generator, cfg: ModelConfig, device) -> Params:
    """One decoder block (dense/moe/audio families, vlm self blocks)."""
    d, hd, dtype = cfg.d_model, cfg.resolved_head_dim, cfg.torch_dtype
    p: Params = {
        "norm_attn": init_norm(d, cfg.norm, dtype, device),
        "attn": attn.init_attention(
            generator, d, cfg.num_heads, cfg.kv_heads, hd, dtype, use_bias=cfg.use_bias,
            device=device,
        ),
        "norm_mlp": init_norm(d, cfg.norm, dtype, device),
    }
    if cfg.moe:
        p["moe"] = init_moe(generator, d, cfg.d_ff, cfg.moe, cfg.act, dtype, device=device)
    elif cfg.d_ff:
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.act, dtype, use_bias=cfg.use_bias,
                            device=device)
    return p


def _init_cross_block(generator: torch.Generator, cfg: ModelConfig, device) -> Params:
    """One gated cross-attention block of a vlm superblock."""
    d, dtype = cfg.d_model, cfg.torch_dtype
    return {
        "norm": init_norm(d, cfg.norm, dtype, device),
        "xattn": attn.init_cross_attention(generator, d, cfg.num_heads, cfg.kv_heads,
                                           cfg.resolved_head_dim, d, dtype, device=device),
        "norm_mlp": init_norm(d, cfg.norm, dtype, device),
        "mlp": init_mlp(generator, d, cfg.d_ff, cfg.act, dtype, device=device),
    }


def _stacked(n: int, make) -> Params:
    """``n`` trees from ``make()`` stacked on a leading axis.  Each is drawn
    and copied into a preallocated stack in turn, so the float32
    temporaries of a draw stay at one layer's size (at chatglm3-6b FULL
    one layer's f32 ``in_gate`` is 224 MB; all 28 would be 6.3 GB)."""
    stack = None
    for i in range(n):
        block = make()
        if stack is None:
            stack = tree_map(
                lambda x: torch.empty((n, *x.shape), dtype=x.dtype, device=x.device), block)
        tree_map(lambda dst, src: dst[i].copy_(src), stack, block)
        del block
    return stack


def vlm_superblocks(cfg: ModelConfig) -> tuple[int, int]:
    """``(n_super, period)``: a vlm stack is ``n_super`` superblocks of
    ``period`` self blocks and one cross block."""
    period = cfg.cross_attn_period
    n_super = cfg.num_layers // (period + 1)
    if n_super * (period + 1) != cfg.num_layers:
        raise ValueError(f"vlm layers {cfg.num_layers} % (period {period} + 1) != 0")
    return n_super, period


def num_slstm(cfg: ModelConfig) -> int:
    """The xlstm stack's sLSTM layers: ``i % slstm_every == 0``."""
    if not cfg.slstm_every:
        return 0
    return sum(1 for i in range(cfg.num_layers) if i % cfg.slstm_every == 0)


def zamba_layout(cfg: ModelConfig) -> tuple[int, int, int]:
    """``(n_super, period, n_tail)``: a hybrid stack is ``n_super``
    superblocks of ``period`` Mamba2 layers, each closed by the shared
    attention, then ``n_tail`` Mamba2 layers."""
    period = cfg.shared_attn_period
    n_super = cfg.num_layers // period
    return n_super, period, cfg.num_layers - n_super * period


def _init_xlstm_layers(generator: torch.Generator, cfg: ModelConfig, device) -> Params:
    dtype = cfg.torch_dtype

    def block(init_cell):
        return lambda: {"norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
                        "cell": init_cell(generator, cfg.d_model, cfg.num_heads, dtype,
                                          device=device)}

    n_s = num_slstm(cfg)
    layers = {"mlstm": _stacked(cfg.num_layers - n_s, block(xlstm.init_mlstm))}
    if n_s:
        layers["slstm"] = _stacked(n_s, block(xlstm.init_slstm))
    return layers


def _init_zamba_layers(generator: torch.Generator, cfg: ModelConfig, device) -> Params:
    dtype = cfg.torch_dtype
    n_super, period, n_tail = zamba_layout(cfg)

    def block():
        return {"norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
                "mamba": mamba2.init_mamba2(generator, cfg.d_model, cfg.ssm_state, dtype,
                                            device=device)}

    body = _stacked(n_super * period, block)
    out = {
        "super": tree_map(lambda x: x.reshape(n_super, period, *x.shape[1:]), body),
        "shared_attn": {
            "norm": init_norm(cfg.d_model, cfg.norm, dtype, device),
            "attn": attn.init_attention(generator, cfg.d_model, cfg.num_heads, cfg.kv_heads,
                                        cfg.resolved_head_dim, dtype, device=device),
        },
    }
    if n_tail:
        out["tail"] = _stacked(n_tail, block)
    return out


def init_lm(generator: torch.Generator, cfg: ModelConfig, *, device=None) -> Params:
    """The parameter tree of an LM of any family, on ``device`` (default
    the generator's; ``"meta"`` for shapes and dtypes alone).  Layers are
    drawn one at a time (:func:`_stacked`)."""
    dtype, device = cfg.torch_dtype, on_device(generator, device)
    params: Params = {"final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device)}
    V = cfg.padded_vocab
    if cfg.family == "audio":
        for c in range(cfg.num_codebooks):
            params[f"embed_{c}"] = embed_init(generator, V, cfg.d_model, dtype, device)
            params[f"head_{c}"] = dense_init(generator, cfg.d_model, V, dtype, device=device)
    else:
        params["embed"] = embed_init(generator, V, cfg.d_model, dtype, device)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(generator, cfg.d_model, V, dtype, device=device)

    if cfg.family == "ssm":
        params["layers"] = _init_xlstm_layers(generator, cfg, device)
    elif cfg.family == "hybrid":
        params["layers"] = _init_zamba_layers(generator, cfg, device)
    elif cfg.family == "vlm":
        n_super, period = vlm_superblocks(cfg)
        blocks = _stacked(n_super * period, lambda: _init_block(generator, cfg, device))
        params["layers"] = {
            "super": tree_map(lambda x: x.reshape(n_super, period, *x.shape[1:]), blocks),
            "cross": _stacked(n_super, lambda: _init_cross_block(generator, cfg, device)),
        }
    else:  # dense | moe | audio
        params["layers"] = _stacked(cfg.num_layers, lambda: _init_block(generator, cfg, device))
    return params


# ========================================================== forward ======


CHUNKED_ATTN_THRESHOLD = 4096  # seqs >= this use flash-style chunked attention


def _maybe_remat(remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``remat`` and
    gradients are on (JAX's ``jax.checkpoint``)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _block_fwd(p: Params, x, cfg: ModelConfig, positions):
    """One dense/moe/audio block.  Returns ``(x, aux)``, ``aux`` the expert
    layer's load-balancing loss (a float32 zero without experts)."""
    attn_fn = (attn.chunked_self_attention if x.shape[1] >= CHUNKED_ATTN_THRESHOLD
               else attn.self_attention)
    h = attn_fn(
        p["attn"], apply_norm(p["norm_attn"], x, cfg.norm),
        num_heads=cfg.num_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions,
        rope_theta=cfg.rope_theta, rope_partial=cfg.rope_2d,
    )
    x = maybe_shard(x + h, ("batch", "seq", "embed"))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.moe:
        xn = apply_norm(p["norm_mlp"], x, cfg.norm)
        if cfg.moe_impl == "shardmap":
            y, aux = apply_moe_shardmap(p["moe"], xn, cfg.moe, cfg.act)
        else:
            y, aux = apply_moe(p["moe"], xn, cfg.moe, cfg.act, num_groups=cfg.moe_groups)
        x = x + y
    elif cfg.d_ff:
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm_mlp"], x, cfg.norm), cfg.act)
    return maybe_shard(x, ("batch", "seq", "embed")), aux


def _scan_blocks(stacked: Params, x, cfg: ModelConfig, positions, *, remat=False):
    """The blocks in order over the stacked layers; ``remat`` recomputes
    each block's activations in backward.  Returns ``(x, summed aux)``."""
    auxs = []
    for i in range(tree_leaves(stacked)[0].shape[0]):
        x, aux = _maybe_remat(remat, _block_fwd, layer_slice(stacked, i), x, cfg, positions)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def cross_block_fwd(p: Params, x, enc, cfg: ModelConfig):
    """The gated cross-attention block closing a vlm superblock."""
    x = x + attn.cross_attention(
        p["xattn"], apply_norm(p["norm"], x, cfg.norm), enc, num_heads=cfg.num_heads,
        kv_heads=cfg.kv_heads, head_dim=cfg.resolved_head_dim,
    )
    return x + apply_mlp(p["mlp"], apply_norm(p["norm_mlp"], x, cfg.norm), cfg.act)


def _superblock_fwd(self_p: Params, cross_p: Params, x, enc, cfg: ModelConfig, positions,
                    remat: bool):
    x, aux = _scan_blocks(self_p, x, cfg, positions, remat=remat)
    return cross_block_fwd(cross_p, x, enc, cfg), aux


def _embed(table, tokens):
    """``table[tokens]``.  In an activation context it is a vocab-parallel
    lookup (``local_map``): where the table's vocab is split, each rank
    looks its tokens up in its own rows, zeros for the others, and the
    sum over the vocab shards is left partial for the next constraint to
    reduce, so the table itself is gathered only over its FSDP dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    _, mesh = _current()
    if mesh is None:
        return table[tokens.long()]
    rep = [Replicate()] * mesh.ndim
    table, tokens = (x if isinstance(x, DTensor) else place(x, mesh, rep) for x in (table, tokens))
    vocab = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    batch = [i not in vocab and p == Shard(0) for i, p in enumerate(tokens.placements)]
    t_pl = [Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim)]
    i_pl = [Shard(0) if b else Replicate() for b in batch]
    t_grad = [Shard(0) if i in vocab else Partial() if batch[i] else Replicate()
              for i in range(mesh.ndim)]
    out_pl = [Partial() if i in vocab else Shard(0) if batch[i] else Replicate()
              for i in range(mesh.ndim)]
    index, count = shard_index(mesh, vocab)
    lo = index * (table.shape[0] // count)

    def lookup(t, ids):
        ids = ids.long() - lo
        hit = (ids >= 0) & (ids < t.shape[0])
        return torch.where(hit[..., None], t[ids.clamp(0, t.shape[0] - 1)], 0)

    return local_map(lookup, out_placements=out_pl, in_placements=(t_pl, i_pl),
                     in_grad_placements=(t_grad, i_pl), redistribute_inputs=True)(table, tokens)


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,               # (b, s) int, or (b, K, s) for audio
    *,
    enc: Optional[torch.Tensor] = None,  # (b, t_img, d): vlm image embeddings
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns ``(logits, aux_loss)``: logits
    ``(b, s, padded_vocab)`` (audio: ``(b, K, s, padded_vocab)``) in the
    model dtype, ``aux_loss`` the float32 sum of the layers' expert
    load-balancing losses (zero without experts).  The vlm family needs
    ``enc``; the others ignore it, as in the reference."""
    if cfg.family == "audio":
        x = sum(_embed(params[f"embed_{c}"], tokens[:, c]) for c in range(cfg.num_codebooks))
    else:
        x = _embed(params["embed"], tokens)
    x = maybe_shard(x, ("batch", "seq", "embed"))
    s = tokens.shape[-1]
    positions = replicate_like(torch.arange(s, device=x.device)[None, :], x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if cfg.family in ("dense", "moe", "audio"):
        x, aux = _scan_blocks(params["layers"], x, cfg, positions, remat=remat)
    elif cfg.family == "vlm":
        if enc is None:
            raise ValueError("forward: the vlm family needs image embeddings (enc=)")
        layers = params["layers"]
        auxs = []
        for i in range(vlm_superblocks(cfg)[0]):
            x, aux = _maybe_remat(remat, _superblock_fwd, layer_slice(layers["super"], i),
                                  layer_slice(layers["cross"], i), x, enc, cfg, positions, remat)
            auxs.append(aux)
        aux = torch.stack(auxs).sum()
    elif cfg.family == "ssm":
        x = _xlstm_forward(params["layers"], x, cfg, remat=remat)
    elif cfg.family == "hybrid":
        x = _zamba_forward(params["layers"], x, cfg, positions, remat=remat)
    else:
        raise ValueError(f"unknown family {cfg.family}")

    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.family == "audio":
        return torch.stack([x @ params[f"head_{c}"] for c in range(cfg.num_codebooks)],
                           dim=1), aux
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return maybe_shard(x @ head, ("batch", "seq", "vocab")), aux


MLSTM_CHUNK_THRESHOLD = 256  # seqs >= this use the chunkwise-parallel mLSTM


def _mlstm_apply(cell_p, x, num_heads):
    """The chunkwise-parallel mLSTM for long sequences, the sequential
    scan for short ones."""
    if x.shape[1] >= MLSTM_CHUNK_THRESHOLD:
        y, _ = xlstm.mlstm_chunked(cell_p, x, num_heads)
    else:
        y, _ = xlstm.mlstm_scan(cell_p, x, num_heads)
    return y


def _mlstm_block(mp: Params, x, cfg: ModelConfig):
    return x + _mlstm_apply(mp["cell"], apply_norm(mp["norm"], x, cfg.norm), cfg.num_heads)


def _xlstm_superblock(s_p: Params, m_p: Params, x, cfg: ModelConfig):
    """One sLSTM block, then the mLSTM blocks stacked in ``m_p``."""
    h, _ = xlstm.slstm_scan(s_p["cell"], apply_norm(s_p["norm"], x, cfg.norm), cfg.num_heads)
    x = x + h
    for j in range(tree_leaves(m_p)[0].shape[0]):
        x = _mlstm_block(layer_slice(m_p, j), x, cfg)
    return x


def _xlstm_forward(layers: Params, x, cfg: ModelConfig, *, remat: bool = False):
    """Alternating sLSTM / mLSTM blocks: sLSTM at ``i % slstm_every == 0``."""
    period = cfg.slstm_every or cfg.num_layers + 1
    n_s = layers["slstm"]["norm"]["scale"].shape[0] if "slstm" in layers else 0
    if n_s:
        m_stacked = tree_map(lambda a: a.reshape(n_s, period - 1, *a.shape[1:]), layers["mlstm"])
        for i in range(n_s):
            x = _maybe_remat(remat, _xlstm_superblock, layer_slice(layers["slstm"], i),
                             layer_slice(m_stacked, i), x, cfg)
    else:
        for j in range(tree_leaves(layers["mlstm"])[0].shape[0]):
            x = _maybe_remat(remat, _mlstm_block, layer_slice(layers["mlstm"], j), x, cfg)
    return x


def _mamba_block(mp: Params, x, cfg: ModelConfig):
    return x + mamba2.apply_mamba2(mp["mamba"], apply_norm(mp["norm"], x, cfg.norm),
                                   ssm_state=cfg.ssm_state)


def _zamba_superblock(mp: Params, shared: Params, x, cfg: ModelConfig, positions, attn_fn):
    """The Mamba2 blocks stacked in ``mp``, then the shared attention."""
    for j in range(tree_leaves(mp)[0].shape[0]):
        x = _mamba_block(layer_slice(mp, j), x, cfg)
    return x + attn_fn(
        shared["attn"], apply_norm(shared["norm"], x, cfg.norm),
        num_heads=cfg.num_heads, kv_heads=cfg.kv_heads, head_dim=cfg.resolved_head_dim,
        positions=positions, rope_theta=cfg.rope_theta,
    )


def _zamba_forward(layers: Params, x, cfg: ModelConfig, positions, *, remat: bool = False):
    """The Mamba2 backbone with ONE shared attention block after every
    ``period`` layers; from ``CHUNKED_ATTN_THRESHOLD`` tokens the shared
    attention is chunked and windowed (4,096)."""
    if x.shape[1] >= CHUNKED_ATTN_THRESHOLD:
        attn_fn = functools.partial(attn.chunked_self_attention, window=4096)
    else:
        attn_fn = attn.self_attention
    for i in range(layers["super"]["norm"]["scale"].shape[0]):
        x = _maybe_remat(remat, _zamba_superblock, layer_slice(layers["super"], i),
                         layers["shared_attn"], x, cfg, positions, attn_fn)
    if "tail" in layers:
        for j in range(tree_leaves(layers["tail"])[0].shape[0]):
            x = _mamba_block(layer_slice(layers["tail"], j), x, cfg)
    return x


# ============================================================= loss ======


def lm_loss(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    enc: Optional[torch.Tensor] = None,
    remat: bool = False,
    aux_weight: float = 0.01,
) -> torch.Tensor:
    """Mean next-token NLL over float32 logits (the padded vocab tail
    masked out of the normalizer), plus ``aux_weight * aux``."""
    logits, aux = forward(params, cfg, tokens, enc=enc, remat=remat)
    logits = logits.float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = replicate_like(
            torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size, logits)
        logits = torch.where(pad_mask, -1e30, logits)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None]).mean()
    return nll + aux_weight * aux
