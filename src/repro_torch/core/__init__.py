"""ReCross core: offline plan (co-occurrence → grouping, Alg. 1 →
replication, Eq. 1 → mapping; host NumPy), the query compile /
reduction over torch tensors, and the ReRAM cost simulator with the
paper's baseline pipelines (host NumPy)."""

from repro_torch.core.cooccurrence import CoOccurrenceGraph, build_cooccurrence
from repro_torch.core.grouping import (
    Grouping,
    correlation_aware_grouping,
    frequency_grouping,
    naive_grouping,
)
from repro_torch.core.replication import ReplicationPlan, plan_replication
from repro_torch.core.mapping import (
    CrossbarLayout,
    build_layout,
    compile_activations,
    query_tile_bitmaps,
)
from repro_torch.core.reduction import (
    BlockUnionTracker,
    BlockedQueries,
    CompiledQueries,
    FusedActivations,
    ShardedBlockedQueries,
    activation_group_loads,
    block_compiled_queries,
    compile_queries,
    concat_compiled_queries,
    fused_group_loads,
    offset_compiled_queries,
    reduce_dense_oracle,
    reduce_via_layout,
    ZeroedBitmaps,
    shard_block_activations,
    shard_block_queries,
)
from repro_torch.core.dynamic_switch import (
    MAC_MODE,
    READ_MODE,
    energy_breakeven_rows,
    mode_statistics,
    popcount,
    select_mode,
    torch_select_mode,
)
from repro_torch.core.energy import DEFAULT_H100, DEFAULT_RERAM, H100CostModel, ReRAMCostModel
from repro_torch.core.simulator import (
    SimReport,
    simulate_batch,
    simulate_cpu_baseline,
    simulate_nmars_baseline,
)
from repro_torch.core import baselines

__all__ = [
    "CoOccurrenceGraph", "build_cooccurrence", "Grouping",
    "correlation_aware_grouping", "frequency_grouping", "naive_grouping",
    "ReplicationPlan", "plan_replication",
    "CrossbarLayout", "build_layout", "compile_activations",
    "query_tile_bitmaps", "BlockUnionTracker", "BlockedQueries", "CompiledQueries",
    "ShardedBlockedQueries", "block_compiled_queries", "compile_queries",
    "concat_compiled_queries", "fused_group_loads", "offset_compiled_queries",
    "reduce_dense_oracle", "reduce_via_layout", "shard_block_queries",
    "FusedActivations", "ZeroedBitmaps", "activation_group_loads",
    "shard_block_activations",
    "READ_MODE", "MAC_MODE", "popcount", "select_mode", "torch_select_mode",
    "energy_breakeven_rows", "mode_statistics",
    "ReRAMCostModel", "DEFAULT_RERAM", "H100CostModel", "DEFAULT_H100",
    "SimReport", "simulate_batch", "simulate_cpu_baseline", "simulate_nmars_baseline",
    "baselines",
]
