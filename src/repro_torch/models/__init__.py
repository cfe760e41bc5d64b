"""Models of the port: DLRM with a ReCross-mapped embedding layer, and
the dense decoder LM's parameters, RoPE and decode attention
(``transformer``, ``rope``, ``attention``) that LM decode serving uses."""

from repro_torch.models.dlrm import (
    DLRMConfig,
    TorchRecDLRMConfig,
    build_images,
    dlrm_forward,
    dlrm_loss,
    init_dense,
    init_dlrm,
)

__all__ = ["DLRMConfig", "TorchRecDLRMConfig", "build_images", "dlrm_forward", "dlrm_loss",
           "init_dense", "init_dlrm"]
