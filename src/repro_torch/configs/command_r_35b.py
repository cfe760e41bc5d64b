"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01; unverified] — GQA, no-bias."""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    kv_heads=8,
    d_ff=22_528,
    vocab_size=256_000,
    use_bias=False,
    norm="layernorm",        # Cohere uses LayerNorm (no bias)
    rope_theta=8e6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=128, num_heads=8, kv_heads=2,
        d_ff=320, vocab_size=512, dtype="float32",
    )
