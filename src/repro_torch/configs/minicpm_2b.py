"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, WSD schedule."""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    schedule="wsd",          # MiniCPM's warmup-stable-decay schedule
    tie_embeddings=True,     # MiniCPM ties input/output embeddings
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=64, num_heads=4, kv_heads=4,
        d_ff=160, vocab_size=256, dtype="float32",
    )
