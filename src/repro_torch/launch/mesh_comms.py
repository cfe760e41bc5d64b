"""The collectives of one LM train step on a device mesh, by op and tensor.

Runs ``lm_loss`` and its gradients (the train step's ``_value_and_grad``)
for a smoke config laid out as the train step lays it out
(``param_specs_for``, ``batch_specs``, inside ``activation_sharding_ctx``)
and counts every collective DTensor issues, forward and backward: calls
and bytes for each op, and for each op and tensor shape, the largest
first.  A call's bytes are those of the larger of its input and its
output on one rank (an all-gather's gathered tensor, a reduce-scatter's
input, an all-reduce's tensor); :meth:`CollectiveCounter.breakdown` keeps
the bytes of each call's result instead, keyed as XLA names its
collectives, for the dry run's roofline (:mod:`repro_torch.launch.roofline`).

Usage::

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.mesh_comms \\
        --device cpu --mesh 2,2 [--arch minicpm-2b] [--moe-impl gspmd] [--seq 16]

Without a started world it makes a world of one process (mesh (1, 1)),
on the card unless ``--device cpu``.  Rank 0 prints one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.dist import sharding as sh
from repro_torch.models.transformer import init_lm
from repro_torch.train.loop import _value_and_grad


# each functional collective DTensor issues, by the name XLA's HLO gives it
HLO_NAMES = {"all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced":
             "all-gather", "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter", "all_reduce": "all-reduce",
             "all_reduce_coalesced": "all-reduce", "all_to_all_single": "all-to-all",
             "broadcast": "broadcast"}


class CollectiveCounter(TorchDispatchMode):
    """Records each ``_c10d_functional`` collective that runs inside it as
    ``(op, shape, bytes, result bytes)``; DTensor ops are let through
    first, so what is seen is what their redistributions issue, on each
    rank's local tensors, once a call (every loop trip is a call)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self.record(func, args, out)
        return out

    def record(self, func, args, out) -> None:
        """Notes ``func`` if it is a functional collective."""
        if func.namespace != "_c10d_functional" or func._opname not in HLO_NAMES:
            return
        outs = [o for o in (out if isinstance(out, (list, tuple)) else [out])
                if isinstance(o, torch.Tensor)]
        ts = [a for a in args if isinstance(a, torch.Tensor)] + outs
        big = max(ts, key=lambda t: t.numel())
        self.calls.append((func._opname, tuple(big.shape), big.numel() * big.element_size(),
                           sum(o.numel() * o.element_size() for o in outs)))

    def breakdown(self) -> dict:
        """Result bytes summed by kind, under XLA's names (``all-gather``,
        ``reduce-scatter``, ``all-reduce``, ``all-to-all``): what the
        reference's ``collective_bytes_from_hlo`` sums."""
        out = defaultdict(int)
        for name, _, _, result in self.calls:
            out[HLO_NAMES[name]] += result
        return dict(out)

    def summary(self, top: Optional[int] = 8) -> dict:
        """Calls and bytes by op, and by (op, shape) the ``top`` largest
        in bytes (all of them at ``None``)."""
        ops = defaultdict(lambda: {"calls": 0, "bytes": 0})
        shapes = defaultdict(lambda: {"calls": 0, "bytes": 0})
        for name, shape, nbytes, _ in self.calls:
            for d in (ops[name], shapes[name, shape]):
                d["calls"] += 1
                d["bytes"] += nbytes
        largest = sorted(shapes.items(), key=lambda kv: -kv[1]["bytes"])[:top]
        return {"calls": len(self.calls), "bytes": sum(c[2] for c in self.calls),
                "by_op": dict(ops),
                "by_shape": [{"op": n, "shape": list(s), **d} for (n, s), d in largest]}


def measure(arch: str, mesh, *, moe_impl: Optional[str] = None, b: int = 4, s: int = 16,
            device="cpu", top: Optional[int] = 8) -> dict:
    """The collectives of one ``_value_and_grad`` of ``arch``'s smoke config
    (float32, seeded) on ``mesh`` (:meth:`CollectiveCounter.summary`);
    every rank of the mesh calls it."""
    from repro_torch.launch.dryrun import batch_specs

    cfg = get_config(arch, smoke=True)
    if moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
    rules = sh.LOGICAL_RULES_SINGLE_POD
    params = init_lm(torch.Generator(device=device).manual_seed(0), cfg)
    params = sh.distribute_tree(
        params, sh.sanitize_specs_tree(sh.param_specs_for(params, rules), params, mesh), mesh)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32))
             .to(device) for k in ("tokens", "labels")}
    batch = sh.distribute_tree(batch, batch_specs(batch, rules, mesh), mesh)
    counter = CollectiveCounter()
    with sh.activation_sharding_ctx(mesh, rules), counter:
        _value_and_grad(cfg, params, batch["tokens"], batch["labels"], None, False)
    return {"arch": arch, "moe_impl": cfg.moe_impl if cfg.moe else None,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "batch": [b, s],
            **counter.summary(top)}


def _cli(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--moe-impl", default=None, choices=(None, "gspmd", "shardmap"))
    ap.add_argument("--mesh", default=None, help="data,model (default 1,world)")
    ap.add_argument("--seq", type=int, default=16, help="tokens a sequence (batch 4)")
    args = ap.parse_args(argv)
    backend = "nccl" if args.device == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:  # torchrun
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        if args.device == "cuda":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        shape = tuple(int(v) for v in args.mesh.split(",")) if args.mesh else \
            (1, dist.get_world_size())
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh(args.device, shape, mesh_dim_names=("data", "model"))
        out = measure(args.arch, mesh, moe_impl=args.moe_impl, s=args.seq, device=args.device)
        if dist.get_rank() == 0:
            print(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(_cli())
