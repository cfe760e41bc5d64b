"""MLPerf Training's DLRM-DCNv2 (Criteo 1TB, synthetic multi-hot).

The published sizes are the flags of the MLPerf reference's README
(github.com/mlcommons/training, ``recommendation_v2/torchrec_dlrm``):
``--num_embeddings_per_feature`` (26 tables, 204,184,588 rows),
``--embedding_dim 128``, ``--multi_hot_sizes`` (fixed bags, 214 lookups a
sample), ``--dense_arch_layer_sizes 512,256,128`` over 13 dense features,
``--over_arch_layer_sizes 1024,1024,512,256,1``, ``--interaction_type dcn
--dcn_num_layers 3 --dcn_low_rank_dim 512``.

:data:`FULL` holds them (104.5 GB of f32 tables); :func:`one_card` is the
share one H100 of the usual deployment holds, one DGX H100 node of 8
cards: each 40M-row table divided row-wise over the 8 (5,000,000 rows
here), the other 21 tables whole, every width and bag as published
(29,184,588 rows, 14.9 GB f32); :func:`smoke` is a CPU size for tests.

Not in ``configs.base``'s registry: ``list_configs()`` is held equal to
the JAX package's list, which has no DCNv2.  Import this module directly.
"""

import dataclasses

from repro_torch.models.dlrm import TorchRecDLRMConfig

#: ``--num_embeddings_per_feature``
NUM_EMBEDDINGS_PER_FEATURE = (
    40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63, 40_000_000,
    3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976, 14, 40_000_000,
    40_000_000, 40_000_000, 590_152, 12_973, 108, 36,
)
#: ``--multi_hot_sizes``
MULTI_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100, 27,
                   10, 3, 1, 1)
#: cards of the deployment that divide each of the largest tables row-wise
CARDS = 8

FULL = TorchRecDLRMConfig(
    name="dlrm-dcnv2",
    embed_dim=128,
    dense_features=13,
    bottom_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    group_size=64,
    dtype="float32",
    table_rows=NUM_EMBEDDINGS_PER_FEATURE,
    bag_sizes=MULTI_HOT_SIZES,
    dcn_num_layers=3,
    dcn_low_rank_dim=512,
)


def one_card() -> TorchRecDLRMConfig:
    """One card's share of an 8-card node: the 40M-row tables at 40M / 8
    rows (their row-wise slice), everything else as :data:`FULL`."""
    largest = max(FULL.table_rows)
    rows = tuple(r // CARDS if r == largest else r for r in FULL.table_rows)
    return dataclasses.replace(FULL, table_rows=rows)


def smoke() -> TorchRecDLRMConfig:
    """Five tables of 3, 10, 63, 2,048 and 1,024 rows (two smaller than
    a 16-row tile), one-hot beside 16-hot, at width 128, with a narrow
    cross network and narrow MLPs."""
    return dataclasses.replace(
        FULL, table_rows=(3, 10, 63, 2048, 1024), bag_sizes=(1, 1, 1, 16, 7),
        bottom_mlp=(64, 128), top_mlp=(64, 1),
        dcn_low_rank_dim=16, group_size=16,
    )
