"""decode_step: one-token decode of a dense LM over a KV cache.

The port of ``repro.serve.decode`` for the dense family.  JAX's
``lax.scan`` over stacked layers becomes a Python loop over layer views;
the cache is updated IN PLACE (JAX returns a new cache): the read-only
path writes every layer's new K/V with one ``index_copy_`` at the
device-side ``len`` after the loop, the writing path inside each layer.
Either way the host never reads ``len``.

An int8 cache (keys ``k_scale``/``v_scale`` present) takes the read-only
path, whose attention runs the flash-decode kernel; new K/V are
quantized as JAX quantizes them: ``s = max|x|/127 + 1e-8`` in float32,
``round(x/s)`` half to even, to int8, the scale stored as bf16.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_mlp, apply_norm, layer_slice

_NOT_PORTED = ("is not ported yet; it comes with the LM-families slices of the "
               "PyTorch port (ROADMAP.md, Queue 1), which has the dense family")


def _attn_kwargs(cfg: ModelConfig) -> dict:
    return dict(num_heads=cfg.num_heads, kv_heads=cfg.kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                rope_partial=cfg.rope_2d)


def _attn_block_decode(p, x, kc, vc, length, cfg: ModelConfig):
    h, kc, vc = attn.decode_attention(
        p["attn"], apply_norm(p["norm_attn"], x, cfg.norm), kc, vc, length,
        **_attn_kwargs(cfg),
    )
    x = x + h
    x = _block_ffn(p, x, cfg)
    return x, kc, vc


def _block_ffn(p, x, cfg: ModelConfig):
    if cfg.moe:
        raise NotImplementedError(f"the MoE block {_NOT_PORTED}")
    if cfg.d_ff:
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm_mlp"], x, cfg.norm), cfg.act)
    return x


def _attn_block_decode_readonly(p, x, kc, vc, length, cfg: ModelConfig, kv_scale=None):
    """Read-only cache variant: returns (x, k_new, v_new); the caller
    writes the cache."""
    h, k_new, v_new = attn.decode_attention_readonly(
        p["attn"], apply_norm(p["norm_attn"], x, cfg.norm), kc, vc, length,
        kv_scale=kv_scale, **_attn_kwargs(cfg),
    )
    x = x + h
    x = _block_ffn(p, x, cfg)
    return x, k_new, v_new


def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,               # (b, 1) int
    cache: Dict[str, Any],
    *,
    readonly_cache: bool = True,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step of a dense LM.

    Returns ``(logits (b, 1, padded_vocab), cache)``; ``cache`` is the
    argument, updated in place (its K/V at position ``len``, then
    ``len + 1``).
    """
    if cfg.family != "dense":
        raise NotImplementedError(f"decode_step: family {cfg.family!r} {_NOT_PORTED}")
    if readonly_cache:
        return _decode_attn_family_readonly(params, cfg, tokens, cache)
    return _decode_attn_family(params, cfg, tokens, cache)


def _embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens.long()]


def _project_logits(params, cfg: ModelConfig, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization over the last axis: ``(int8 values,
    float32 scales)`` with ``s = max|x|/127 + 1e-8``."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _decode_attn_family_readonly(params, cfg, tokens, cache):
    """The layer loop reads the caches; all layers' new K/V are written
    in ONE update after it (int8-quantized when the cache is)."""
    x = _embed_tokens(params, cfg, tokens)          # (b, 1, d)
    length = cache["len"]
    quant = "k_scale" in cache
    k_new, v_new = [], []
    for i in range(cfg.num_layers):
        kv_scale = (cache["k_scale"][i], cache["v_scale"][i]) if quant else None
        x, k, v = _attn_block_decode_readonly(
            layer_slice(params["layers"], i), x, cache["k"][i], cache["v"][i],
            length, cfg, kv_scale=kv_scale,
        )
        k_new.append(k)
        v_new.append(v)
    k_new = torch.stack(k_new)                      # (L, b, 1, kvh, hd)
    v_new = torch.stack(v_new)

    if quant:
        kq, ks = quantize(k_new)
        vq, vs = quantize(v_new)
        attn.write_at(cache["k"], 2, length, kq)
        attn.write_at(cache["v"], 2, length, vq)
        attn.write_at(cache["k_scale"], 2, length, ks.to(cache["k_scale"].dtype))
        attn.write_at(cache["v_scale"], 2, length, vs.to(cache["v_scale"].dtype))
    else:
        attn.write_at(cache["k"], 2, length, k_new.to(cache["k"].dtype))
        attn.write_at(cache["v"], 2, length, v_new.to(cache["v"].dtype))
    length.add_(1)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _project_logits(params, cfg, x), cache


def _decode_attn_family(params, cfg, tokens, cache):
    if "k_scale" in cache:
        # JAX's dynamic_update_slice refuses float K/V into an int8 cache
        raise TypeError("an int8 cache takes the read-only path (readonly_cache=True)")
    x = _embed_tokens(params, cfg, tokens)          # (b, 1, d)
    length = cache["len"]
    for i in range(cfg.num_layers):
        x, _, _ = _attn_block_decode(
            layer_slice(params["layers"], i), x, cache["k"][i], cache["v"][i], length, cfg)
    length.add_(1)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _project_logits(params, cfg, x), cache
