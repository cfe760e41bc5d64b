"""Shard placement of the fused crossbar image and its incremental
patches (host NumPy)."""

from repro_torch.dist.replan import (
    PagingPolicy,
    PlanPatch,
    apply_plan_patch,
    compute_plan_patch,
    rescale_load_to_plan,
)
from repro_torch.dist.shard_plan import ShardPlan, build_fused_image, plan_shards

__all__ = [
    "ShardPlan", "build_fused_image", "plan_shards",
    "PagingPolicy", "PlanPatch", "apply_plan_patch", "compute_plan_patch",
    "rescale_load_to_plan",
]
