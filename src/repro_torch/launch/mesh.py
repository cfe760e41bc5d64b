"""Production mesh construction over a torch ``DeviceMesh``.

The port of ``repro.launch.mesh``.  Every mesh is built by a FUNCTION
(not a module constant) so importing this module touches no process
group or device: a mesh needs the world that the caller has started
(``torch.distributed.init_process_group``), and tests import every
module.  ``init_device_mesh`` lays the mesh over that world's ranks in
order.  The device type is ``"cuda"`` unless the caller asks for the CPU.

This is the LM's ``("data", "model")`` mesh (:mod:`repro_torch.dist.
sharding`); the serving combine's one-process-per-shard world is
:mod:`repro_torch.dist.mesh`.
"""

from __future__ import annotations

from typing import Optional


def _mesh(shape, axes, device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or "cuda", shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """16×16 single-pod (256 chips) or 2×16×16 multi-pod (512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(device_type: Optional[str] = None):
    """Degenerate 1×1 mesh on the local device (smoke tests, examples)."""
    return _mesh((1, 1), ("data", "model"), device_type)


def mesh_axis_sizes(mesh) -> dict:
    """``{axis name: size}``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def chips(mesh) -> int:
    """The devices of the mesh."""
    return mesh.size()
