"""Decoder LM parameters for the dense family.

The port of ``repro.models.transformer``'s ``_init_block`` and ``init_lm``
for ``family == "dense"``: pre-norm GQA attention + (Sw/Ge)GLU MLP
blocks, layer parameters stacked on a leading ``L`` axis as JAX's
``stack_layers`` does, the vocab padded to ``cfg.padded_vocab``,
``tie_embeddings`` and ``use_bias`` as configured.  The other families
(moe, vlm, audio, ssm, hybrid) and ``forward`` come with the LM-stack
slice of the port.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Params,
    dense_init,
    embed_init,
    init_mlp,
    init_norm,
    tree_map,
)


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
    if cfg.family != "dense":
        raise NotImplementedError(
            f"init_lm: family {cfg.family!r} is not ported yet; it comes with the "
            f"LM-stack slice of the PyTorch port, which has the dense family"
        )
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
