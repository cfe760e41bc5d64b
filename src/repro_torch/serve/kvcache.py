"""KV caches and recurrent state for decode, as plain dicts of tensors.

The port of ``repro.serve.kvcache``.  A stack of attention layers carries ``(L, b, max_seq, kv_heads, head_dim)`` K/V
buffers plus the number of cached tokens, ``len``, a 0-d int32 tensor on
the cache's device (decode reads it there; the host never waits for
it).  ``quant=True`` stores int8 entries with per-(token, kv-head) bf16
scales: 4x less device memory per cached token than f32 and 2x less
than bf16, and the flash-decode kernel reads the int8 entries directly.
A vlm cache holds the ``n_super · period`` self-attention layers and is
never quantized: the reference's ignores ``quant`` for vlm, and so does
this one.

The recurrent families carry O(1) state a layer, float32 except the
Mamba2 conv window: xlstm (ssm) the mLSTM ``(C, n, m)`` and the sLSTM
``(c, n, h, m)`` of every layer; zamba2 (hybrid) the Mamba2 SSM and conv
state of the superblocks' layers and of the tail (at least one layer
even when the stack has no tail, as in the reference), and a sliding-
window ring for the shared attention: ``min(window, max_seq)`` slots of
K/V with the absolute position stored beside each (``pos``, -1 while
empty), its own ``len`` beside the cache's.  Neither grows with the
sequence, and both ignore ``quant``, as the reference's do.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.models.mamba2 import CONV_W
from repro_torch.models.transformer import num_slstm, vlm_superblocks, zamba_layout


def make_attn_cache(cfg: ModelConfig, batch: int, max_seq: int, *, layers: int | None = None,
                    quant: bool = False, device="cuda") -> Dict[str, torch.Tensor]:
    """(k, v, len) cache for a stack of ``layers`` attention layers (default
    the model's), zero-filled."""
    L = cfg.num_layers if layers is None else layers
    shape = (L, batch, max_seq, cfg.kv_heads, cfg.resolved_head_dim)
    length = torch.zeros((), dtype=torch.int32, device=device)
    if quant:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device),
            "len": length,
        }
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "len": length,
    }


def make_ring_cache(cfg: ModelConfig, batch: int, window: int, *, layers: int,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """Sliding-window ring cache of ``layers`` attention layers (the
    hybrid's shared attention): ``window`` slots, positions -1 (empty)."""
    shape = (layers, batch, window, cfg.kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
        "pos": torch.full((layers, batch, window), -1, dtype=torch.int32, device=device),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def make_mamba_state(cfg: ModelConfig, batch: int, *, layers: int, head_dim: int = 64,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """Zero Mamba2 SSM state (float32) and conv window (model dtype) for
    ``layers`` layers."""
    d_inner = 2 * cfg.d_model
    heads = d_inner // head_dim
    return {
        "h": torch.zeros((layers, batch, heads, head_dim, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((layers, batch, CONV_W - 1, d_inner), dtype=cfg.torch_dtype,
                            device=device),
    }


def make_xlstm_state(cfg: ModelConfig, batch: int, *, n_slstm: int, n_mlstm: int,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """The xLSTM state at its start: mLSTM ``C, n`` zero and ``m = -1e30``;
    sLSTM ``c, h, m`` zero and ``n = 1``."""
    d, H = cfg.d_model, cfg.num_heads
    hd = d // H

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    return {
        "m_C": full((n_mlstm, batch, H, hd, hd), 0.0),
        "m_n": full((n_mlstm, batch, H, hd), 0.0),
        "m_m": full((n_mlstm, batch, H), -1e30),
        "s_c": full((n_slstm, batch, d), 0.0),
        "s_n": full((n_slstm, batch, d), 1.0),
        "s_h": full((n_slstm, batch, d), 0.0),
        "s_m": full((n_slstm, batch, d), 0.0),
        "len": torch.zeros((), dtype=torch.int32, device=device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, window: int = 4096,
               quant: bool = False, device="cuda") -> Dict[str, Any]:
    """Family-dispatching cache constructor for ``decode_step``
    (``window``: the hybrid's ring slots, at most ``max_seq``)."""
    if cfg.family in ("dense", "moe", "audio"):
        return make_attn_cache(cfg, batch, max_seq, quant=quant, device=device)
    if cfg.family == "vlm":
        n_super, period = vlm_superblocks(cfg)
        return make_attn_cache(cfg, batch, max_seq, layers=n_super * period, device=device)
    if cfg.family == "ssm":
        n_s = num_slstm(cfg)
        return make_xlstm_state(cfg, batch, n_slstm=n_s, n_mlstm=cfg.num_layers - n_s,
                                device=device)
    if cfg.family == "hybrid":
        n_super, period, n_tail = zamba_layout(cfg)
        return {
            "mamba": make_mamba_state(cfg, batch, layers=n_super * period, device=device),
            "tail": make_mamba_state(cfg, batch, layers=max(n_tail, 1), device=device),
            "shared": make_ring_cache(cfg, batch, min(window, max_seq), layers=n_super,
                                      device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device),
        }
    raise ValueError(f"no cache for family {cfg.family}")


def cache_slots(cache: Dict[str, Any]) -> int:
    """The sequences a cache holds: the batch axis, second on every
    tensor but the lengths."""
    return next(t.shape[1] for t in tree_leaves(cache) if t.dim() > 1)


def cache_bytes(cache) -> int:
    """Total bytes across every tensor of a cache."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache))
