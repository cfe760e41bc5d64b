"""decode_step: one-token decode of an LM over a KV cache.

The port of ``repro.serve.decode``.  JAX's ``lax.scan`` over stacked
layers becomes a Python loop over layer views; the cache is updated IN
PLACE (JAX returns a new cache): the read-only path writes every layer's
new K/V with one ``index_copy_`` at the device-side ``len`` after the
loop, the writing path inside each layer.  Either way the host never
reads ``len``.

An int8 cache (keys ``k_scale``/``v_scale`` present) takes the read-only
path, whose attention runs the flash-decode kernel; new K/V are
quantized as JAX quantizes them: ``s = max|x|/127 + 1e-8`` in float32,
``round(x/s)`` half to even, to int8, the scale stored as bf16.

The moe block runs ``apply_moe`` without ``num_groups`` (the forward
passes ``cfg.moe_groups``), as the reference's decode does.  Audio
tokens are ``(b, K, 1)`` and the logits ``(b, K, 1, V)``.  The vlm family
takes the writing path over its self-attention layers, viewed
``(n_super, period, …)``, with a cross-attention block over ``enc``
closing each superblock, whatever ``readonly_cache`` says (as in JAX).

The recurrent families step their O(1) state: xlstm (ssm) runs each
sLSTM/mLSTM scan at ``s = 1`` from the layer's state, zamba2 (hybrid)
each Mamba2 recurrence and, after every superblock, the shared attention
over its ring of ``W`` slots.  Each new state is ``copy_``-ed into the
cache's tensor.  The ring slot is ``len % W`` on the device, written
with ``index_copy_`` (with the absolute position in ``pos``); writing
past ``W`` wraps by design, where the dense cache's write past
``max_seq`` raises.  A slot takes part when ``0 <= pos <= len``, masked
before the float32 softmax.  Both of the hybrid's lengths (``len`` and
``shared["len"]``) count up in place.

On a device mesh (inside an activation context, the cache laid out by
the dry run's ``cache_specs``) the embedding is the vocab-parallel
lookup, every cache write goes to each rank's own shard
(``attention.write_at``), each new state is laid out as the cache's
before its copy, and the attention runs on local shards (see
:mod:`repro_torch.models.attention`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import placed_like
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, xlstm
from repro_torch.models.layers import apply_mlp, apply_norm, layer_slice
from repro_torch.models.moe import apply_moe
from repro_torch.models.rope import apply_rope
from repro_torch.models.transformer import _embed, cross_block_fwd, vlm_superblocks


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
        y, _ = apply_moe(p["moe"], apply_norm(p["norm_mlp"], x, cfg.norm), cfg.moe, cfg.act)
        x = x + y
    elif cfg.d_ff:
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
    tokens: torch.Tensor,               # (b, 1) int, or (b, K, 1) for audio
    cache: Dict[str, Any],
    *,
    enc: Optional[torch.Tensor] = None,  # (b, t_img, d): vlm image embeddings
    readonly_cache: bool = True,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step, dispatched by model family.

    Returns ``(logits (b, 1, padded_vocab), cache)`` (audio: ``(b, K, 1,
    padded_vocab)``); ``cache`` is the argument, updated in place (its K/V
    at position ``len``, then ``len + 1``).
    """
    if cfg.family in ("dense", "moe", "audio"):
        if readonly_cache:
            return _decode_attn_family_readonly(params, cfg, tokens, cache)
        return _decode_attn_family(params, cfg, tokens, cache)
    if cfg.family == "vlm":
        return _decode_vlm(params, cfg, tokens, cache, enc)
    if cfg.family == "ssm":
        return _decode_xlstm(params, cfg, tokens, cache)
    if cfg.family == "hybrid":
        return _decode_zamba(params, cfg, tokens, cache)
    raise ValueError(cfg.family)


def _embed_tokens(params, cfg: ModelConfig, tokens):
    if cfg.family == "audio":
        return sum(_embed(params[f"embed_{c}"], tokens[:, c]) for c in range(cfg.num_codebooks))
    return _embed(params["embed"], tokens)


def _project_logits(params, cfg: ModelConfig, x):
    if cfg.family == "audio":
        return torch.stack([x @ params[f"head_{c}"] for c in range(cfg.num_codebooks)], dim=1)
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


def _decode_vlm(params, cfg, tokens, cache, enc):
    """The writing path over the self-attention layers, the cache viewed
    ``(n_super, period, …)``; each superblock ends with its cross block."""
    if enc is None:
        raise ValueError("decode_step: the vlm family needs image embeddings (enc=)")
    if "k_scale" in cache:
        raise TypeError("a vlm cache is never int8 (init_cache ignores quant for vlm)")
    n_super, period = vlm_superblocks(cfg)
    k5 = cache["k"].view(n_super, period, *cache["k"].shape[1:])
    v5 = cache["v"].view(n_super, period, *cache["v"].shape[1:])
    x = _embed_tokens(params, cfg, tokens)          # (b, 1, d)
    length = cache["len"]
    layers = params["layers"]
    for i in range(n_super):
        self_p = layer_slice(layers["super"], i)
        for j in range(period):
            x, _, _ = _attn_block_decode(layer_slice(self_p, j), x, k5[i, j], v5[i, j],
                                         length, cfg)
        x = cross_block_fwd(layer_slice(layers["cross"], i), x, enc, cfg)
    length.add_(1)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _project_logits(params, cfg, x), cache


def _write_state(dst: tuple, src: tuple) -> None:
    for d, v in zip(dst, src):
        d.copy_(placed_like(v, d))


def _decode_xlstm(params, cfg, tokens, cache):
    """Every sLSTM block followed by its ``period - 1`` mLSTM blocks; with
    no sLSTM (``slstm_every = 0``) the mLSTM blocks alone."""
    x = _embed_tokens(params, cfg, tokens)
    layers = params["layers"]
    n_s = cache["s_c"].shape[0]
    n_m_per = cache["m_C"].shape[0] // max(n_s, 1)   # the mLSTM blocks after each sLSTM

    def mlstm(x, j):
        mp = layer_slice(layers["mlstm"], j)
        st = (cache["m_C"][j], cache["m_n"][j], cache["m_m"][j])
        y, new = xlstm.mlstm_decode_step(mp["cell"], apply_norm(mp["norm"], x, cfg.norm), st,
                                         cfg.num_heads)
        _write_state(st, new)
        return x + y

    for i in range(max(n_s, 1)):
        if n_s:
            sp = layer_slice(layers["slstm"], i)
            st = (cache["s_c"][i], cache["s_n"][i], cache["s_h"][i], cache["s_m"][i])
            y, new = xlstm.slstm_decode_step(sp["cell"], apply_norm(sp["norm"], x, cfg.norm),
                                             st, cfg.num_heads)
            _write_state(st, new)
            x = x + y
        for j in range(n_m_per):
            x = mlstm(x, i * n_m_per + j)
    cache["len"].add_(1)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _project_logits(params, cfg, x), cache


def _mamba_decode(mp, x, h, conv, cfg: ModelConfig):
    y, h_new, conv_new = mamba2.mamba2_decode_step(
        mp["mamba"], apply_norm(mp["norm"], x, cfg.norm), h, conv, ssm_state=cfg.ssm_state)
    _write_state((h, conv), (h_new, conv_new))
    return x + y


def _decode_zamba(params, cfg, tokens, cache):
    """Each superblock's Mamba2 layers, then the shared attention over the
    superblock's ring; the tail's Mamba2 layers last."""
    x = _embed_tokens(params, cfg, tokens)
    layers = params["layers"]
    length = cache["len"]
    period = cfg.shared_attn_period
    ring, state = cache["shared"], cache["mamba"]
    for i in range(layers["super"]["norm"]["scale"].shape[0]):
        sp = layer_slice(layers["super"], i)
        for j in range(period):
            layer = i * period + j
            x = _mamba_decode(layer_slice(sp, j), x, state["h"][layer], state["conv"][layer], cfg)
        x = _ring_attention_at(layers["shared_attn"], x, ring["k"][i], ring["v"][i],
                               ring["pos"][i], length, cfg)
    if "tail" in layers:
        tail = cache["tail"]
        for j in range(layers["tail"]["norm"]["scale"].shape[0]):
            x = _mamba_decode(layer_slice(layers["tail"], j), x, tail["h"][j], tail["conv"][j],
                              cfg)
    ring["len"].add_(1)
    length.add_(1)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _project_logits(params, cfg, x), cache


def _ring_attention_at(p, x, kc, vc, pc, length, cfg: ModelConfig):
    """The shared attention at position ``len`` over one layer's ring
    ``kc``/``vc`` ``(b, W, kvh, hd)`` and positions ``pc`` ``(b, W)``,
    written in place at slot ``len % W``.  Returns ``x + out``."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    W = kc.shape[1]
    pos = length.to(torch.int32).expand(b, 1)
    q, k, v = attn._project(p["attn"], apply_norm(p["norm"], x, cfg.norm), cfg.num_heads,
                            cfg.kv_heads, hd)
    q = apply_rope(q, pos, theta=cfg.rope_theta)
    k = apply_rope(k, pos, theta=cfg.rope_theta)

    slot = length % W
    attn.write_at(kc, 1, slot, k)
    attn.write_at(vc, 1, slot, v)
    attn.write_at(pc, 1, slot, pos)
    valid = (pc >= 0) & (pc <= length)
    if attn.seq_split_dims(kc):
        out = attn.attention_over_seq_shards(q, kc, vc, valid, x.dtype, 1.0 / math.sqrt(hd))
        return x + out @ p["attn"]["wo"]
    scores = attn._gqa_scores(q, kc).float() / math.sqrt(hd)
    scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    w = torch.softmax(scores, dim=-1).to(x.dtype)
    return x + attn._gqa_out(w, vc) @ p["attn"]["wo"]
