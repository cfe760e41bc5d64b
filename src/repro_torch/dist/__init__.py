"""Distribution layer: logical-axis sharding rules, pipeline parallelism,
and the shard placement of the fused crossbar image with its incremental
patches.

``repro_torch.dist.sharding`` owns the logical→mesh translation of the LM
over a torch ``DeviceMesh`` (DTensor placements), the activation
constraints (no-ops outside a mesh context) and the name-pattern
parameter specs; ``repro_torch.dist.pipeline_parallel`` owns the
GPipe-style stage rotation and its schedule math.  ``shard_plan`` and
``replan`` are host NumPy; ``repro_torch.dist.mesh`` is the serving
combine's one-process-per-shard world.
"""

from repro_torch.dist import pipeline_parallel, sharding
from repro_torch.dist.replan import (
    PagingPolicy,
    PlanPatch,
    apply_plan_patch,
    compute_plan_patch,
    rescale_load_to_plan,
)
from repro_torch.dist.shard_plan import ShardPlan, build_fused_image, plan_shards

__all__ = [
    "sharding", "pipeline_parallel",
    "ShardPlan", "build_fused_image", "plan_shards",
    "PagingPolicy", "PlanPatch", "apply_plan_patch", "compute_plan_patch",
    "rescale_load_to_plan",
]
