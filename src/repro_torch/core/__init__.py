"""ReCross core: offline plan (co-occurrence → grouping, Alg. 1 →
replication, Eq. 1 → mapping; host NumPy) and the query compile /
reduction over torch tensors."""

from repro_torch.core.cooccurrence import CoOccurrenceGraph, build_cooccurrence
from repro_torch.core.grouping import Grouping, correlation_aware_grouping
from repro_torch.core.replication import ReplicationPlan, plan_replication
from repro_torch.core.mapping import (
    CrossbarLayout,
    build_layout,
    compile_activations,
    query_tile_bitmaps,
)
from repro_torch.core.reduction import (
    BlockedQueries,
    CompiledQueries,
    ShardedBlockedQueries,
    block_compiled_queries,
    compile_queries,
    concat_compiled_queries,
    offset_compiled_queries,
    reduce_dense_oracle,
    reduce_via_layout,
    shard_block_queries,
)

__all__ = [
    "CoOccurrenceGraph", "build_cooccurrence", "Grouping",
    "correlation_aware_grouping", "ReplicationPlan", "plan_replication",
    "CrossbarLayout", "build_layout", "compile_activations",
    "query_tile_bitmaps", "BlockedQueries", "CompiledQueries",
    "ShardedBlockedQueries", "block_compiled_queries", "compile_queries",
    "concat_compiled_queries", "offset_compiled_queries",
    "reduce_dense_oracle", "reduce_via_layout", "shard_block_queries",
]
