"""Decoder LM of the attention families: parameters, full-sequence
forward and the training loss.

The port of ``repro.models.transformer`` for the families built on its
attention blocks:

  dense  — pre-norm GQA attention + (Sw/Ge)GLU MLP blocks;
  moe    — the MLP replaced by a top-k expert layer
           (:mod:`repro_torch.models.moe`), its load-balancing loss
           summed over the layers into ``aux``;
  vlm    — superblocks of ``cross_attn_period`` self-attention blocks and
           one gated cross-attention block over image embeddings ``enc``
           (``layers = {"super": (n_super, period, …), "cross":
           (n_super, …)}``);
  audio  — ``num_codebooks`` embeddings summed at the input and as many
           heads out (``embed_{c}``/``head_{c}``; logits ``(b, K, s, V)``).

``init_lm`` keeps JAX's leaf names, nesting and shapes (layer parameters
stacked on leading axes as JAX's ``stack_layers`` does, the vocab padded
to ``cfg.padded_vocab``), so ``convert.lm_params_from_numpy`` and the
checkpoints carry trees across unchanged.  ``forward`` runs the embedding
gather, the blocks, the final norm and the head(s); sequences of at least
``CHUNKED_ATTN_THRESHOLD`` tokens take ``chunked_self_attention``.  JAX's
``lax.scan`` over stacked layers is a Python loop over layer views;
``remat=True`` wraps each block (and each vlm superblock) in
``torch.utils.checkpoint`` where JAX wraps it in ``jax.checkpoint``.
One-token decode is ``repro_torch.serve.decode``.

The recurrent families (ssm, hybrid) raise ``NotImplementedError``: they
come with the next LM-families slice of the port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
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
    tree_map,
)
from repro_torch.models.moe import apply_moe, apply_moe_shardmap, init_moe

ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")
_NOT_PORTED = ("is not ported yet; the ssm and hybrid families come with the next "
               "LM-families slice of the PyTorch port (ROADMAP.md, Queue 1)")


def _require_attention_family(fn: str, cfg: ModelConfig) -> None:
    if cfg.family not in ATTENTION_FAMILIES:
        raise NotImplementedError(f"{fn}: family {cfg.family!r} {_NOT_PORTED}")


def _init_block(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """One decoder block (dense/moe/audio families, vlm self blocks)."""
    d, hd, dtype = cfg.d_model, cfg.resolved_head_dim, cfg.torch_dtype
    device = generator.device
    p: Params = {
        "norm_attn": init_norm(d, cfg.norm, dtype, device),
        "attn": attn.init_attention(
            generator, d, cfg.num_heads, cfg.kv_heads, hd, dtype, use_bias=cfg.use_bias
        ),
        "norm_mlp": init_norm(d, cfg.norm, dtype, device),
    }
    if cfg.moe:
        p["moe"] = init_moe(generator, d, cfg.d_ff, cfg.moe, cfg.act, dtype)
    elif cfg.d_ff:
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.act, dtype, use_bias=cfg.use_bias)
    return p


def _init_cross_block(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """One gated cross-attention block of a vlm superblock."""
    d, dtype, device = cfg.d_model, cfg.torch_dtype, generator.device
    return {
        "norm": init_norm(d, cfg.norm, dtype, device),
        "xattn": attn.init_cross_attention(generator, d, cfg.num_heads, cfg.kv_heads,
                                           cfg.resolved_head_dim, d, dtype),
        "norm_mlp": init_norm(d, cfg.norm, dtype, device),
        "mlp": init_mlp(generator, d, cfg.d_ff, cfg.act, dtype),
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


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """The parameter tree of an LM of an attention family, on the
    generator's device.  Layers are drawn one at a time (:func:`_stacked`)."""
    _require_attention_family("init_lm", cfg)
    dtype, device = cfg.torch_dtype, generator.device
    params: Params = {"final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device)}
    V = cfg.padded_vocab
    if cfg.family == "audio":
        for c in range(cfg.num_codebooks):
            params[f"embed_{c}"] = embed_init(generator, V, cfg.d_model, dtype)
            params[f"head_{c}"] = dense_init(generator, cfg.d_model, V, dtype)
    else:
        params["embed"] = embed_init(generator, V, cfg.d_model, dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(generator, cfg.d_model, V, dtype)

    if cfg.family == "vlm":
        n_super, period = vlm_superblocks(cfg)
        blocks = _stacked(n_super * period, lambda: _init_block(generator, cfg))
        params["layers"] = {
            "super": tree_map(lambda x: x.reshape(n_super, period, *x.shape[1:]), blocks),
            "cross": _stacked(n_super, lambda: _init_cross_block(generator, cfg)),
        }
    else:  # dense | moe | audio
        params["layers"] = _stacked(cfg.num_layers, lambda: _init_block(generator, cfg))
    return params


# ========================================================== forward ======


CHUNKED_ATTN_THRESHOLD = 4096  # seqs >= this use flash-style chunked attention


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
    x = x + h
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
    return x, aux


def _scan_blocks(stacked: Params, x, cfg: ModelConfig, positions, *, remat=False):
    """The blocks in order over the stacked layers; ``remat`` recomputes
    each block's activations in backward.  Returns ``(x, summed aux)``."""
    auxs = []
    for i in range(tree_leaves(stacked)[0].shape[0]):
        layer_p = layer_slice(stacked, i)
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_block_fwd, layer_p, x, cfg, positions, use_reentrant=False)
        else:
            x, aux = _block_fwd(layer_p, x, cfg, positions)
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
    _require_attention_family("forward", cfg)
    if cfg.family == "audio":
        x = sum(params[f"embed_{c}"][tokens[:, c].long()] for c in range(cfg.num_codebooks))
    else:
        x = params["embed"][tokens.long()]
    s = tokens.shape[-1]
    positions = torch.arange(s, device=x.device)[None, :]

    if cfg.family == "vlm":
        if enc is None:
            raise ValueError("forward: the vlm family needs image embeddings (enc=)")
        layers = params["layers"]
        auxs = []
        for i in range(vlm_superblocks(cfg)[0]):
            args = (layer_slice(layers["super"], i), layer_slice(layers["cross"], i), x, enc,
                    cfg, positions, remat)
            if remat and torch.is_grad_enabled():
                x, aux = checkpoint(_superblock_fwd, *args, use_reentrant=False)
            else:
                x, aux = _superblock_fwd(*args)
            auxs.append(aux)
        aux = torch.stack(auxs).sum()
    else:
        x, aux = _scan_blocks(params["layers"], x, cfg, positions, remat=remat)

    x = apply_norm(params["final_norm"], x, cfg.norm)
    if cfg.family == "audio":
        return torch.stack([x @ params[f"head_{c}"] for c in range(cfg.num_codebooks)],
                           dim=1), aux
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head, aux


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
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad_mask, -1e30, logits)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None]).mean()
    return nll + aux_weight * aux
