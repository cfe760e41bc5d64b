"""Llama-3.2-Vision-11B [hf:meta-llama; unverified] — cross-attn image layers.

40 layers = 8 superblocks of (4 self-attn + 1 gated cross-attn).  The
vision frontend is a STUB: ``input_specs()`` supplies precomputed patch
embeddings (b, num_image_tokens, d_model).
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    kv_heads=8,
    d_ff=14_336,
    vocab_size=128_256,
    cross_attn_period=4,      # 4 self layers per cross layer
    num_image_tokens=1601,    # 448px / 14 patches + cls, one tile
    rope_theta=5e5,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=5, d_model=64, num_heads=4, kv_heads=2,
        d_ff=192, vocab_size=256, cross_attn_period=4, num_image_tokens=16,
        dtype="float32",
    )
