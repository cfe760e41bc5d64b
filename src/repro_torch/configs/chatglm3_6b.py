"""ChatGLM3-6B [arXiv:2406.12793; hf] — dense, GQA kv=2, RoPE-2d (partial)."""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    kv_heads=2,
    d_ff=13_696,
    vocab_size=65_024,
    rope_2d=True,            # GLM rotary on half the head dims
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=64, num_heads=4, kv_heads=2,
        d_ff=192, vocab_size=256, dtype="float32",
    )
