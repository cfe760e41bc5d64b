"""MusicGen-medium [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

4 parallel codebooks (vocab 2048 each) summed at input, 4 LM heads out.
The EnCodec frontend is a STUB: tokens arrive as (b, 4, s) int32.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    norm="layernorm",
    act="gelu",
    use_bias=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=64, num_heads=4, kv_heads=4,
        d_ff=128, vocab_size=64, num_codebooks=2, dtype="float32",
    )
