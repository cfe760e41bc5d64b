"""Grok-1 314B [hf:xai-org/grok-1; unverified] — MoE 8 experts top-2, GQA kv=8."""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    kv_heads=8,
    d_ff=32_768,
    vocab_size=131_072,
    moe=MoEConfig(num_experts=8, top_k=2),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=128, vocab_size=256, moe=MoEConfig(num_experts=4, top_k=2),
        dtype="float32",
    )
