"""DLRM with ReCross embedding reduction — the paper's own workload."""

import dataclasses

from repro_torch.models.dlrm import DLRMConfig

FULL = DLRMConfig(
    name="dlrm-recross",
    num_tables=8,
    rows_per_table=932_019,     # automotive (paper Table I)
    embed_dim=64,
    dense_features=13,
    bottom_mlp=(512, 256, 64),
    top_mlp=(1024, 512, 1),
    max_bag=64,
    group_size=64,
)


def smoke() -> DLRMConfig:
    return dataclasses.replace(
        FULL, num_tables=2, rows_per_table=2048, embed_dim=128,
        bottom_mlp=(64, 128), top_mlp=(64, 1), max_bag=16,
        group_size=16,
    )
