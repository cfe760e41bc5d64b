"""Model configurations of the port (``dlrm_recross`` and the LM configs
of every family: dense, moe, vlm, audio, ssm and hybrid) and the
``--arch`` registry."""

from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    get_config,
    list_configs,
    supported_shapes,
)

__all__ = [
    "ARCH_IDS", "SHAPES", "ModelConfig", "MoEConfig", "ShapeConfig",
    "get_config", "list_configs", "supported_shapes",
]
