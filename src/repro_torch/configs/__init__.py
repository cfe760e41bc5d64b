"""Model configurations of the port (``dlrm_recross`` and the LM configs
of the dense, moe, vlm and audio families) and the ``--arch`` registry."""

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
