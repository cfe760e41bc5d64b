"""Zamba2-7B [arXiv:2411.15242; unverified] — Mamba2 + shared attention.

81 layers = 13 superblocks of 6 Mamba2 layers + 1 SHARED attention block
application (single param copy) + 3 tail Mamba2 layers.  Recurrent
backbone + windowed shared attention → sub-quadratic: runs long_500k.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    kv_heads=32,
    d_ff=14_336,              # (unused by mamba blocks; kept for reporting)
    vocab_size=32_000,
    ssm_state=64,
    shared_attn_period=6,
    subquadratic=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=5, d_model=64, num_heads=4, kv_heads=4,
        d_ff=0, vocab_size=256, ssm_state=16, shared_attn_period=2,
        dtype="float32",
    )
