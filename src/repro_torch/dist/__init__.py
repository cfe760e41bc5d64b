"""Shard placement of the fused crossbar image (host NumPy)."""

from repro_torch.dist.shard_plan import ShardPlan, build_fused_image, plan_shards

__all__ = ["ShardPlan", "build_fused_image", "plan_shards"]
