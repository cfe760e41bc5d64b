"""Models of the port: DLRM with a ReCross-mapped embedding layer."""

from repro_torch.models.dlrm import (
    DLRMConfig,
    build_images,
    dlrm_forward,
    dlrm_loss,
    init_dlrm,
)

__all__ = ["DLRMConfig", "build_images", "dlrm_forward", "dlrm_loss", "init_dlrm"]
