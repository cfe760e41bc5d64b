"""Decoder LM of the dense family: parameters, full-sequence forward and
the training loss.

The port of ``repro.models.transformer`` for ``family == "dense"``:
``init_lm`` (pre-norm GQA attention + (Sw/Ge)GLU MLP blocks, layer
parameters stacked on a leading ``L`` axis as JAX's ``stack_layers``
does, the vocab padded to ``cfg.padded_vocab``, ``tie_embeddings`` and
``use_bias`` as configured), ``forward`` (the embedding gather, the
blocks, the final norm and the head; sequences of at least
``CHUNKED_ATTN_THRESHOLD`` tokens take ``chunked_self_attention``) and
``lm_loss``.  JAX's ``lax.scan`` over the stacked layers is a Python loop
over layer views; ``remat=True`` wraps each block in
``torch.utils.checkpoint`` where JAX wraps it in ``jax.checkpoint``.
One-token decode is ``repro_torch.serve.decode``.

The other families (moe, vlm, audio, ssm, hybrid) raise
``NotImplementedError``: they come with the LM-families slices of the
port (ROADMAP.md, Queue 1), the moe family first.
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
    apply_mlp,
    apply_norm,
    dense_init,
    embed_init,
    init_mlp,
    init_norm,
    layer_slice,
    tree_map,
)

_NOT_PORTED = ("is not ported yet; it comes with the LM-families slices of the "
               "PyTorch port (ROADMAP.md, Queue 1), which has the dense family")


def _require_dense(fn: str, cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"{fn}: family {cfg.family!r} {_NOT_PORTED}")


def _init_block(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """One decoder block (dense family)."""
    d, hd, dtype = cfg.d_model, cfg.resolved_head_dim, cfg.torch_dtype
    device = generator.device
    p: Params = {
        "norm_attn": init_norm(d, cfg.norm, dtype, device),
        "attn": attn.init_attention(
            generator, d, cfg.num_heads, cfg.kv_heads, hd, dtype, use_bias=cfg.use_bias
        ),
        "norm_mlp": init_norm(d, cfg.norm, dtype, device),
    }
    if cfg.d_ff:
        p["mlp"] = init_mlp(generator, d, cfg.d_ff, cfg.act, dtype, use_bias=cfg.use_bias)
    return p


def init_lm(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """The parameter tree of a dense LM, on the generator's device.

    Layers are drawn one at a time and copied into a preallocated stack,
    so the float32 temporaries of the draw stay at one layer's size (at
    chatglm3-6b FULL one layer's f32 ``in_gate`` is 224 MB; stacked it
    would be 6.3 GB).
    """
    _require_dense("init_lm", cfg)
    dtype, device = cfg.torch_dtype, generator.device
    params: Params = {"final_norm": init_norm(cfg.d_model, cfg.norm, dtype, device)}
    V = cfg.padded_vocab
    params["embed"] = embed_init(generator, V, cfg.d_model, dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, V, dtype)

    L = cfg.num_layers
    layers = None
    for i in range(L):
        block = _init_block(generator, cfg)
        if layers is None:
            layers = tree_map(
                lambda x: torch.empty((L, *x.shape), dtype=x.dtype, device=x.device), block)
        tree_map(lambda dst, src: dst[i].copy_(src), layers, block)
        del block
    params["layers"] = layers
    return params


# ========================================================== forward ======


CHUNKED_ATTN_THRESHOLD = 4096  # seqs >= this use flash-style chunked attention


def _block_fwd(p: Params, x, cfg: ModelConfig, positions):
    """One dense block.  Returns ``(x, aux)``, ``aux`` a float32 zero."""
    attn_fn = (attn.chunked_self_attention if x.shape[1] >= CHUNKED_ATTN_THRESHOLD
               else attn.self_attention)
    h = attn_fn(
        p["attn"], apply_norm(p["norm_attn"], x, cfg.norm),
        num_heads=cfg.num_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions,
        rope_theta=cfg.rope_theta, rope_partial=cfg.rope_2d,
    )
    x = x + h
    if cfg.d_ff:
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm_mlp"], x, cfg.norm), cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _scan_blocks(stacked: Params, x, cfg: ModelConfig, positions, *, remat=False):
    """The blocks in order over the stacked layers; ``remat`` recomputes
    each block's activations in backward.  Returns ``(x, summed aux)``."""
    auxs = []
    for i in range(cfg.num_layers):
        layer_p = layer_slice(stacked, i)
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_block_fwd, layer_p, x, cfg, positions, use_reentrant=False)
        else:
            x, aux = _block_fwd(layer_p, x, cfg, positions)
        auxs.append(aux)
    return x, torch.stack(auxs).sum()


def forward(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,               # (b, s) int
    *,
    enc: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns ``(logits (b, s, padded_vocab),
    aux_loss)``, the logits in the model dtype."""
    _require_dense("forward", cfg)
    if enc is not None:
        raise NotImplementedError(f"forward: image embeddings (the vlm family) {_NOT_PORTED}")
    x = params["embed"][tokens.long()]
    s = tokens.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    x, aux = _scan_blocks(params["layers"], x, cfg, positions, remat=remat)
    x = apply_norm(params["final_norm"], x, cfg.norm)
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
