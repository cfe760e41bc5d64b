"""Access-aware crossbar allocation (ReCross §III-C, Eq. 1).

Even after correlation-aware grouping, group access frequency remains
power-law: a few hot crossbars serialize the queries of a batch while the
rest idle.  ReCross replicates hot groups, with a *log-scaled* copy count

    num_copies(g) = floor( log(freq_g) / log(freq_total) * log(batch) )

(Eq. 1).  Log scaling (a) tames the head of the power law so replication
does not explode area, and (b) still hands every moderately-hot group at
least one extra copy.

The same equation drives two placements:

  * **intra-shard replicas** — extra physical tiles inside one model shard,
    so concurrent queries of a batch hit different tiles (the paper's
    stall-cycle fix);
  * **cross-shard replication** — groups whose copy count reaches the
    model-parallel degree are stored fully replicated instead of sharded
    (consumed by :mod:`repro_torch.dist.shard_plan`).

A NumPy copy of ``repro.core.replication``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np

from repro_torch.core.grouping import Grouping


@dataclasses.dataclass
class ReplicationPlan:
    """Per-group replica counts and the area budget they consume.

    Attributes:
      copies: ``(num_groups,)`` int32 — number of *physical copies* of each
        group (>= 1; 1 means not replicated).
      duplication_ratio: extra area as a fraction of the unreplicated image
        (paper Fig. 10 sweeps 0/5/10/20 %).
      batch_size: the batch size Eq. 1 was evaluated with.
    """

    copies: np.ndarray
    duplication_ratio: float
    batch_size: int

    @property
    def num_groups(self) -> int:
        return int(self.copies.shape[0])

    @property
    def total_tiles(self) -> int:
        return int(self.copies.sum())

    def extra_tiles(self) -> int:
        return self.total_tiles - self.num_groups


def log_scaled_copies(
    group_freq: np.ndarray,
    batch_size: int,
    *,
    base_copies: int = 1,
    total: float | None = None,
) -> np.ndarray:
    """Eq. 1 of the paper, vectorized over groups.

    ``num_copies = floor(log(freq)/log(freq_total) * log(batch))`` *extra*
    copies on top of the mandatory one.  Groups with zero recorded accesses
    get the base copy only.

    ``total`` overrides the normalizing ``freq_total`` (default: the sum
    of ``group_freq``).  The online replanner passes the full segment's
    mass while evaluating Eq. 1 on only the drifted *subset* of groups —
    the copy count of group ``g`` depends on the rest of the table only
    through this total, so a subset evaluation with the full-table total
    is exact.
    """
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    freq = np.asarray(group_freq, dtype=np.float64)
    total = float(freq.sum()) if total is None else float(total)
    out = np.full(freq.shape, base_copies, dtype=np.int32)
    if total <= 1.0 or batch_size == 1:
        return out
    pos = freq >= 1.0
    scale = math.log(float(batch_size)) / math.log(float(total))
    extra = np.floor(np.log(np.maximum(freq, 1.0)) * scale).astype(np.int32)
    out[pos] += np.maximum(extra[pos], 0)
    return out


def linear_copies(group_freq: np.ndarray, batch_size: int) -> np.ndarray:
    """Baseline: naive frequency-proportional duplication (paper Fig. 5 left).

    Allocates copies proportional to raw frequency.  Under a power law this
    leaves "most crossbars unduplicated" while the head hoards copies —
    shown only as the ablation baseline.
    """
    freq = np.asarray(group_freq, dtype=np.float64)
    total = freq.sum()
    if total <= 0:
        return np.ones(freq.shape, dtype=np.int32)
    share = freq / total
    return (1 + np.floor(share * batch_size)).astype(np.int32)


def plan_replication(
    grouping: Grouping,
    freq: np.ndarray,
    batch_size: int,
    *,
    area_budget_ratio: float | None = None,
    scheme: str = "log",
) -> ReplicationPlan:
    """Builds the replication plan for a grouping.

    Args:
      grouping: output of the grouping pass.
      freq: per-row access frequency (graph.freq).
      batch_size: inference batch size (Eq. 1's ``batch``).
      area_budget_ratio: optional cap on extra area (paper Fig. 10's
        Dup-5%/10%/20%).  When set, extra copies are granted to the
        hottest groups first until the budget is exhausted.
      scheme: "log" (Eq. 1), "linear" (ablation baseline) or "none".

    Returns:
      A :class:`ReplicationPlan`.
    """
    gfreq = grouping.group_freq(np.asarray(freq))
    if scheme == "none":
        copies = np.ones(grouping.num_groups, dtype=np.int32)
    elif scheme == "log":
        copies = log_scaled_copies(gfreq, batch_size)
    elif scheme == "linear":
        copies = linear_copies(gfreq, batch_size)
    else:
        raise ValueError(f"unknown replication scheme {scheme!r}")

    if area_budget_ratio is not None:
        copies = _apply_area_budget(copies, gfreq, area_budget_ratio)

    ratio = float(copies.sum() - len(copies)) / max(len(copies), 1)
    return ReplicationPlan(copies=copies, duplication_ratio=ratio, batch_size=batch_size)


def _apply_area_budget(
    copies: np.ndarray, gfreq: np.ndarray, budget_ratio: float
) -> np.ndarray:
    """Clamps total extra copies to ``budget_ratio * num_groups``.

    Extra copies are granted in descending group-frequency order, one
    round-robin layer at a time, so the budget preferentially covers the
    hottest groups but never gives a group more than Eq. 1 asked for.
    """
    n = len(copies)
    budget = int(math.floor(budget_ratio * n))
    want_extra = np.maximum(copies - 1, 0)
    granted = np.zeros_like(want_extra)
    order = np.argsort(-gfreq, kind="stable")
    # layer-by-layer grant: first copy to all hot groups, then second, ...
    layer = 1
    while budget > 0 and (want_extra > granted).any():
        for g in order:
            if budget == 0:
                break
            if want_extra[g] >= layer and granted[g] < layer:
                granted[g] += 1
                budget -= 1
        layer += 1
    return (1 + granted).astype(np.int32)


def shard_replication_sets(
    plan: ReplicationPlan, model_parallelism: int
) -> np.ndarray:
    """Derives the cross-shard placement from a replication plan.

    Groups whose copy count is >= ``model_parallelism`` are flagged for
    full replication across model-parallel shards (they leave the
    all-to-all path entirely); the rest stay sharded.

    Returns:
      ``(num_groups,)`` bool — True where the group is replicated across
      shards.
    """
    return plan.copies >= max(model_parallelism, 2)
