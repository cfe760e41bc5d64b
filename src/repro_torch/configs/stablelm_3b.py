"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b family; unverified] — dense."""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    norm="layernorm",        # StableLM uses LayerNorm
    use_bias=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=64, num_heads=4, kv_heads=4,
        d_ff=192, vocab_size=256, dtype="float32",
    )
