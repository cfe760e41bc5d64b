"""KV caches for decode, as plain dicts of tensors.

The port of ``repro.serve.kvcache`` for the attention families: a stack
of attention layers carries ``(L, b, max_seq, kv_heads, head_dim)`` K/V
buffers plus the number of cached tokens, ``len``, a 0-d int32 tensor on
the cache's device (decode reads it there; the host never waits for
it).  ``quant=True`` stores int8 entries with per-(token, kv-head) bf16
scales: 4x less device memory per cached token than f32 and 2x less
than bf16, and the flash-decode kernel reads the int8 entries directly.
A vlm cache holds the ``n_super · period`` self-attention layers and is
never quantized: the reference's ignores ``quant`` for vlm, and so does
this one.  The recurrent and ring caches (ssm, hybrid) come with the
next LM-families slice.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import tree_leaves
from repro_torch.models.transformer import vlm_superblocks


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


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *, quant: bool = False,
               device="cuda") -> Dict[str, Any]:
    """Family-dispatching cache constructor for ``decode_step``."""
    if cfg.family in ("dense", "moe", "audio"):
        return make_attn_cache(cfg, batch, max_seq, quant=quant, device=device)
    if cfg.family == "vlm":
        n_super, period = vlm_superblocks(cfg)
        return make_attn_cache(cfg, batch, max_seq, layers=n_super * period, device=device)
    raise NotImplementedError(
        f"init_cache: family {cfg.family!r} is not ported yet; the ssm and hybrid "
        "families come with the next LM-families slice of the PyTorch port "
        "(ROADMAP.md, Queue 1)"
    )


def cache_bytes(cache) -> int:
    """Total bytes across every tensor of a cache."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(cache))
