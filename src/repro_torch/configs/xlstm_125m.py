"""xLSTM-125M [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks, no FFN.

Linear recurrence → sub-quadratic: runs the long_500k cell.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    kv_heads=4,
    d_ff=0,                   # xLSTM blocks carry their own projections
    vocab_size=50_304,
    slstm_every=6,            # sLSTM at layers 0 and 6, mLSTM elsewhere
    subquadratic=True,
    norm="layernorm",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=4, d_model=64, num_heads=2, kv_heads=2,
        vocab_size=256, slstm_every=2, dtype="float32",
    )
