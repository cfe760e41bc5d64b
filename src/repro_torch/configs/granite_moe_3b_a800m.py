"""Granite-MoE 3B-a800m [hf:ibm-granite; hf] — MoE 40 experts top-8."""

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

FULL = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    kv_heads=8,
    d_ff=512,                 # per-expert FFN width
    vocab_size=49_155,
    moe=MoEConfig(num_experts=40, top_k=8),
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=64, vocab_size=256, moe=MoEConfig(num_experts=8, top_k=2),
        dtype="float32",
    )
