"""Roofline analysis of the dry run's cells on NVIDIA H100 cards.

The port of ``repro.launch.roofline``.  Three terms per (arch × shape ×
mesh), in seconds (``H100CostModel``, :mod:`repro_torch.core.energy`):

    compute    = FLOPs            / (chips × 989e12 bf16 FLOP/s)
    memory     = bytes accessed   / (chips × 3.35e12 B/s HBM)
    collective = collective bytes / (chips × link B/s)
                 (NVLink 450e9 for ≤ 8 cards, else the 50e9 network link)

The reference reads FLOPs and bytes from a compiled XLA artifact's
``cost_analysis()`` and parses the collectives out of its HLO text.  The
port has no compiled artifact, so :class:`StepCounter` counts one rank's
program while it runs (the dry run runs it on meta tensors), each count
in the reference's meaning:

  * ``hlo_flops`` — each op's FLOPs on the rank's local tensors by
    ``FlopCounterMode``'s formulas (``torch.utils.flop_counter``): a
    per-device count, as ``cost_analysis()`` gives.  DTensor ops are let
    through first, so an op is seen once, on local shards.
  * ``hlo_bytes`` — each op's input and output bytes on the rank,
    unfused: an upper bound of its HBM traffic (XLA fuses elementwise
    chains; eager torch runs each op alone).  Views move nothing.
  * ``collective_breakdown`` — each functional collective's *result*
    bytes by kind, under XLA's names
    (:meth:`repro_torch.launch.mesh_comms.CollectiveCounter.breakdown`).
    Counting as the program runs sees every loop trip, so no trip-count
    correction is needed: the reference's HLO parser
    (``collective_bytes_from_hlo`` and its helpers) has no counterpart.

The compute and memory terms use the exact analytic counts
(:mod:`repro_torch.launch.analytic`) where the caller gives them, as the
reference's do; where it does not (the DLRM cell), ``compute_s`` divides
the per-device FLOPs by ``chips`` once more, as the reference's does.

Also computes MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) and the
usefulness ratio MODEL_FLOPS / FLOPs (catches remat & redundancy).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.core.energy import DEFAULT_H100, H100CostModel
from repro_torch.launch.mesh_comms import CollectiveCounter


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(CollectiveCounter):
    """FLOPs, bytes accessed, collectives and the peak of the bytes it made
    live, over what runs inside it on one rank's local tensors.

    ``flops`` and ``bytes`` are the report's ``hlo_flops`` and
    ``hlo_bytes``; ``peak_bytes`` is the largest sum, at any op, of the
    storages made inside the counter and still alive (outputs included
    while they live), each counted once however many views it has."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak_bytes = 0
        self._storages = set()

    def _free(self, key, nbytes) -> None:
        self._storages.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            # under a fake mode: DTensor's sharding propagation runs each new
            # op once on global-shape fake tensors, which is not the rank's work
            return out
        self.record(func, args, out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs or func.is_view or func.namespace == "_c10d_functional":
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        owned = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in owned or key in self._storages:
                continue
            self._storages.add(key)
            self.live += st.nbytes()
            weakref.finalize(st, self._free, key, st.nbytes())
        self.peak_bytes = max(self.peak_bytes, self.live)
        return out


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float               # per-device FLOPs counted on local shards
    hlo_bytes: float               # per-device op bytes, unfused (an upper bound)
    collective_bytes: float        # per-device collective result bytes, every trip
    collective_breakdown: Dict[str, int]
    model_flops: Optional[float] = None
    bytes_per_device: Optional[float] = None
    analytic_flops: Optional[float] = None   # exact formula (compute term)
    analytic_bytes: Optional[float] = None   # exact formula (memory term)
    gpu: H100CostModel = dataclasses.field(default_factory=lambda: DEFAULT_H100)

    @property
    def compute_s(self) -> float:
        f = self.analytic_flops if self.analytic_flops else self.hlo_flops
        return self.gpu.compute_time(f, self.chips)

    @property
    def memory_s(self) -> float:
        b = self.analytic_bytes if self.analytic_bytes else self.hlo_bytes
        return self.gpu.memory_time(b, self.chips)

    @property
    def collective_s(self) -> float:
        return self.gpu.collective_time(self.collective_bytes, self.chips)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max(all terms): 1.0 = perfectly compute-bound."""
        t = self.bound_time_s
        return self.compute_s / t if t > 0 else 0.0

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS (6·N_active·D) / analytic compiled FLOPs."""
        denom = self.analytic_flops or self.hlo_flops
        if self.model_flops is None or not denom:
            return None
        return self.model_flops / denom

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_breakdown": self.collective_breakdown,
            "model_flops": self.model_flops,
            "analytic_flops": self.analytic_flops,
            "analytic_bytes": self.analytic_bytes,
            "bytes_per_device": self.bytes_per_device,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def analyse(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    counter: StepCounter,
    bytes_per_device: Optional[float] = None,
    model_flops: Optional[float] = None,
    analytic_flops: Optional[float] = None,
    analytic_bytes: Optional[float] = None,
) -> RooflineReport:
    """The report of one rank's program as ``counter`` counted it
    (the reference's reads a compiled artifact)."""
    breakdown = counter.breakdown()
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=float(counter.flops), hlo_bytes=float(counter.bytes),
        collective_bytes=float(sum(breakdown.values())),
        collective_breakdown=breakdown, model_flops=model_flops,
        bytes_per_device=bytes_per_device,
        analytic_flops=analytic_flops, analytic_bytes=analytic_bytes,
    )


def model_flops_for(cfg, shape_cfg) -> float:
    """6·N_active·D for a train step (fwd+bwd); fwd-only for serving."""
    n = cfg.active_param_count()
    tokens = shape_cfg.global_batch * (
        shape_cfg.seq_len if shape_cfg.kind != "decode" else 1
    )
    if shape_cfg.kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens
