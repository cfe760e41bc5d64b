"""Elastic re-mesh: checkpoint on mesh A, lose ranks, resume on the
survivors' mesh B with the numerics of a run that never stopped.

The port of ``examples/elastic_restart.py``, as SPMD over the world the
caller started (every rank calls :func:`main`):

  1. train the ``minicpm-2b`` smoke LM ``STEPS_BEFORE`` steps on mesh A,
     ``("data", "model")``, parameters and AdamW state laid out FSDP × TP
     (``shardings_for``), inside ``activation_sharding_ctx``; save a
     checkpoint (the state gathered, written by rank 0);
  2. go on ``STEPS_AFTER`` steps on mesh A: the uninterrupted run;
  3. "lose" ranks: ``plan_remesh`` gives mesh B on the first
     ``survivors`` ranks, model axis kept.  Every rank takes part in
     making B's process groups; the ranks outside B then wait;
  4. restore the checkpoint onto mesh B with ``restore(..., shardings=)``
     and train ``STEPS_AFTER`` steps; the losses must equal the
     uninterrupted run's within ``LOSS_ATOL``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.elastic_restart             # the card
    PYTHONPATH=src python -m repro_torch.launch.elastic_restart --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.elastic_restart \
        --device cpu --mesh-a 2,2 --survivors 2

Without a started world the command makes a world of one process
(mesh A = mesh B = (1, 1)): NCCL on the card, gloo on the CPU.  The
device defaults to ``cuda``; nothing moves to the CPU unless asked.  On
the card the command turns deterministic algorithms on, so A = B = (1, 1)
replays bit for bit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import tempfile
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenBatcher
from repro_torch.dist.sharding import (
    LOGICAL_RULES_SINGLE_POD,
    P,
    activation_sharding_ctx,
    distribute_tree,
    gather_tree,
    map_specs,
    param_specs_for,
    sanitize_specs_tree,
    to_placements,
)
from repro_torch.launch.dryrun import batch_specs, opt_state_specs
from repro_torch.models.transformer import init_lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import plan_remesh
from repro_torch.train.loop import TrainState, init_train_state, make_train_step
from repro_torch.train.optimizer import AdamW

ARCH = "minicpm-2b"
STEPS_BEFORE, STEPS_AFTER = 6, 6
BATCH, SEQ, LR = 16, 32, 1e-3
RULES = LOGICAL_RULES_SINGLE_POD
#: post-restart against uninterrupted losses.  A mesh B with the same
#: data-parallel degree replays bit for bit; fewer data shards sum the
#: gradients in another order, a few float32 ulps of the loss.
LOSS_ATOL = 1e-5


def state_specs(state: TrainState, mesh) -> TrainState:
    """Specs of the whole train state: parameters by name (FSDP × TP), the
    optimizer's moments after them, the step replicated."""
    p_specs = sanitize_specs_tree(param_specs_for(state.params, RULES), state.params, mesh)
    return TrainState(params=p_specs, opt_state=opt_state_specs(state.opt_state, p_specs, mesh),
                      step=P())


def shardings_for(state: TrainState, mesh) -> TrainState:
    """``restore``'s ``shardings=``: a ``(mesh, placements)`` pair a leaf."""
    return map_specs(lambda s: (mesh, to_placements(s, mesh)), state_specs(state, mesh))


def _scalar(x) -> float:
    return float(x.to_local() if hasattr(x, "to_local") else x)


def run(mesh, state, data, start, steps, step_fn, device):
    """``steps`` train steps from ``start`` on ``mesh``; the state and the
    losses."""
    losses = []
    with activation_sharding_ctx(mesh, RULES):
        for s in range(start, start + steps):
            tokens, labels = data.batch(s)
            batch = {"tokens": torch.from_numpy(tokens).to(device),
                     "labels": torch.from_numpy(labels).to(device)}
            batch = distribute_tree(batch, batch_specs(batch, RULES, mesh), mesh)
            state, metrics = step_fn(state, batch)
            losses.append(_scalar(metrics["loss"]))
    return state, losses


def _device(device: str) -> torch.device:
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("elastic_restart: no CUDA device (pass device='cpu' for the CPU)")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def main(device: str = "cuda", mesh_a: Optional[Sequence[int]] = None,
         survivors: Optional[int] = None, ckpt_dir: Optional[str] = None) -> dict:
    """Runs the restart on every rank of the world that stands (a world of
    one is made, and ended, when none does).  ``mesh_a`` defaults to
    ``(1, world)``; ``survivors`` (ranks) to half of mesh A, at least one
    model replica.  Raises ``AssertionError`` if the post-restart losses
    leave the uninterrupted ones by more than ``LOSS_ATOL``.  Returns the
    losses and meshes (every rank)."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    dev = _device(device)
    own_world = not dist.is_initialized()
    if own_world:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        mesh_a = tuple(mesh_a or (1, world))
        survivors = survivors or max(math.prod(mesh_a) // 2, mesh_a[1])
        cfg = get_config(ARCH, smoke=True)
        opt = AdamW(schedule=lambda s: LR)
        step_fn = make_train_step(cfg, opt)
        data = TokenBatcher(cfg.vocab_size, batch_size=BATCH, seq_len=SEQ, seed=0)

        mesh = init_device_mesh(dev.type, mesh_a, mesh_dim_names=("data", "model"))
        state = init_train_state(init_lm(torch.Generator(dev).manual_seed(0), cfg), opt)
        state = distribute_tree(state, state_specs(state, mesh), mesh)
        state, losses_a = run(mesh, state, data, 0, STEPS_BEFORE, step_fn, dev)

        made_dir = ckpt_dir is None
        if made_dir:
            box = [tempfile.mkdtemp(prefix="elastic_") if rank == 0 else None]
            dist.broadcast_object_list(box, src=0)
            ckpt_dir = box[0]
        try:
            host = gather_tree(state)
            if rank == 0:
                ckpt.save(ckpt_dir, STEPS_BEFORE, host)
            dist.barrier()
            # the uninterrupted run goes on from the same state
            _, ref_b = run(mesh, state, data, STEPS_BEFORE, STEPS_AFTER, step_fn, dev)

            # --- failure: only the first `survivors` ranks remain -------
            shape_b = plan_remesh(n_hosts=survivors, chips_per_host=1,
                                  model_parallelism=mesh_a[-1])
            # every rank of the world makes B's groups; those outside B wait
            mesh_b = DeviceMesh(dev.type, torch.arange(math.prod(shape_b)).reshape(shape_b),
                                mesh_dim_names=("data", "model"))
            losses_b = None
            if rank < math.prod(shape_b):
                restored = ckpt.restore(ckpt_dir, STEPS_BEFORE, host,
                                        shardings=shardings_for(host, mesh_b))
                _, losses_b = run(mesh_b, restored, data, STEPS_BEFORE, STEPS_AFTER, step_fn,
                                  dev)
            dist.barrier()
        finally:
            if made_dir and rank == 0:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
    finally:
        if own_world:
            dist.destroy_process_group()

    out = {"arch": ARCH, "rank": rank, "mesh_a": list(mesh_a), "mesh_b": list(shape_b),
           "losses_a": losses_a, "uninterrupted": ref_b, "restarted": losses_b}
    if losses_b is not None:
        diff = max(abs(a - b) for a, b in zip(losses_b, ref_b))
        out.update(max_abs_diff=diff, bit_equal=losses_b == ref_b, atol=LOSS_ATOL)
        if not diff <= LOSS_ATOL:
            raise AssertionError(f"elastic restart diverged from the uninterrupted run: "
                                 f"max |Δloss| {diff:.3e} > {LOSS_ATOL}")
    return out


def _cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mesh-a", default=None, help="data,model (default 1,world)")
    ap.add_argument("--survivors", type=int, default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        # bit-equal replays need cuBLAS's fixed workspace before its first call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cuda.matmul.allow_tf32 = False
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():  # torchrun
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    mesh_a = tuple(int(v) for v in args.mesh_a.split(",")) if args.mesh_a else None
    try:
        out = main(device=args.device, mesh_a=mesh_a, survivors=args.survivors)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if out["rank"] == 0:
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
