"""GPipe-style pipeline parallelism over a "stage" mesh axis.

The port of ``repro.dist.pipeline_parallel``.  ``pipelined_apply`` runs
``M`` microbatches through ``S`` stages with the classic fill/drain
rotation: at tick ``t`` stage ``s`` processes microbatch ``t - s`` (when
valid) and hands its activation to stage ``s + 1``.  Completion takes
``M + S - 1`` ticks; the fill/drain overhead is :func:`bubble_fraction`.

Each stage is one rank of the mesh's ``"stage"`` dimension, and the
hand-off is a point-to-point ``send``/``recv`` between neighbouring
stage ranks (JAX's ``ppermute``).  The last stage's outputs are then
broadcast over the stage group, so every rank returns them (the
reference's ``psum`` of the masked outputs).  gloo cannot send or
receive a CUDA tensor, so on a gloo group a CUDA activation crosses
through host memory, as :mod:`repro_torch.dist.mesh` stages its result.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    """Idle fraction of the ideal schedule: (S-1) / (M + S-1)."""
    if num_microbatches < 1 or num_stages < 1:
        raise ValueError("need at least one microbatch and one stage")
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def _send(t: torch.Tensor, dst: int, group, via_host: bool) -> None:
    dist.send(t.cpu() if via_host else t.contiguous(), dst, group=group)


def _recv(like: torch.Tensor, src: int, group, via_host: bool) -> torch.Tensor:
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if via_host else like.device)
    dist.recv(buf, src, group=group)
    return buf.to(like.device)


def pipelined_apply(
    w: torch.Tensor,               # (S, ...) stacked per-stage params
    x: torch.Tensor,               # (M, microbatch, d) microbatched input
    body: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    mesh,
) -> torch.Tensor:
    """Applies ``body(w[s], ·)`` for s = 0..S-1 over every microbatch.

    ``w`` and ``x`` are the same global tensors on every rank (each stage
    uses only ``w[s]``); ``body`` keeps the activation's shape and dtype.
    Returns the (M, microbatch, d) outputs of the final stage on every
    rank, equal to running all stages in order on one device.
    """
    num_stages = _mesh_stage_size(mesh)
    if w.shape[0] != num_stages:
        raise ValueError(
            f"w has {w.shape[0]} stages but mesh 'stage' axis is {num_stages}"
        )
    num_micro = x.shape[0]
    ticks = num_micro + num_stages - 1
    group = mesh.get_group("stage")
    stage = mesh.get_local_rank("stage")
    ranks = [dist.get_global_rank(group, i) for i in range(num_stages)]
    via_host = x.is_cuda and dist.get_backend(group) == "gloo"
    w_stage = w[stage]

    outputs = torch.zeros_like(x)
    for t in range(ticks):
        m = t - stage
        if not 0 <= m < num_micro:
            continue
        # stage 0 draws fresh microbatches; later stages take the
        # activation the previous stage handed over at the last tick
        h_in = x[m] if stage == 0 else _recv(x[0], ranks[stage - 1], group, via_host)
        h_out = body(w_stage, h_in)
        if stage < num_stages - 1:
            _send(h_out, ranks[stage + 1], group, via_host)
        else:
            outputs[m] = h_out
    # only the final stage's records are the pipeline output
    if num_stages > 1:
        dist.broadcast(outputs, ranks[-1], group=group)
    return outputs


def _mesh_stage_size(mesh) -> int:
    sizes = dict(zip(mesh.mesh_dim_names or (), tuple(mesh.shape)))
    if "stage" not in sizes:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no 'stage' axis")
    return int(sizes["stage"])
