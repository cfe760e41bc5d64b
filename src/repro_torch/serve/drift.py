"""Serve-time access-frequency drift tracking (DESIGN.md §6).

The port of ``repro.serve.drift``: the observation half of online
replanning.  The shard plan was balanced and Eq.-1-replicated for
*training-time* group frequencies, but serving traffic drifts.  The
tracker keeps an exponentially decayed per-fused-group load estimate
from the batches the server actually compiles, and reports a drift
statistic against the load the live plan was built for.  When the
statistic crosses :attr:`ReplanConfig.threshold`, the server asks
:func:`repro_torch.dist.replan.compute_plan_patch` for an incremental
patch.

The drift statistic is total-variation distance between the *normalized*
decayed observation and the *normalized* plan load:

    drift = ½ · Σ_g | p̂_g − p_g |   ∈ [0, 1]

The decayed estimate is seeded with the plan's own load, so an
undrifted workload starts at drift ≈ 0 and the training prior fades with
a half-life of ``half_life`` flushes as real observations arrive.

:class:`LoadObservationCache` memoizes the per-batch load observation
by compiled-batch content: a replayed or steady-state stream re-flushes
byte-identical compiled batches, and a content digest is one pass over
the arrays where the observation is several.  The server observes the
sparse :class:`~repro_torch.core.reduction.FusedActivations` of a batch
(:func:`~repro_torch.core.reduction.activation_group_loads`); a dense
compile is observed with :func:`~repro_torch.core.reduction.
fused_group_loads`, and both give the same loads for the same batch.

Everything here is host work on the host compile: it reads no tensor on
the card, so it overlaps a flush's kernels instead of waiting for them.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.core.reduction import (
    FusedActivations,
    activation_group_loads,
    fused_group_loads,
)


@dataclasses.dataclass
class ReplanConfig:
    """Online-replanning knobs for the sharded embedding server.

    Attributes:
      threshold: total-variation drift that triggers a plan patch
        (0 = patch on any wobble, 1 = never).
      half_life: flushes after which an observation's weight halves in
        the decayed load estimate (also how fast the training-time prior
        fades).
      min_queries: observed queries required before the first patch may
        trigger.
      eq1_batch: Eq. 1's ``batch`` for the replicate-vs-shard threshold
        at replan time; ``None`` uses the server's ``batch_size_for_eq1``.
      slack_tiles: extra zero tiles of per-shard image headroom allocated
        at build, so early promotions reuse slack instead of growing
        (reallocating) the image stack on the device.
      shrink_streak: consecutive demotion-only patches after which slack
        capacity ages out — the next patch also shrinks the image stack
        back to the highest allocated slot + ``slack_tiles``.  0 disables
        age-out.
    """

    threshold: float = 0.25
    half_life: float = 8.0
    min_queries: int = 64
    eq1_batch: int | None = None
    slack_tiles: int = 0
    shrink_streak: int = 0


class DriftTracker:
    """Decayed per-group load estimate + total-variation drift statistic.

    Host NumPy; every method is O(G) and runs between a flush's kernel
    dispatch and the wait for its event.
    """

    def __init__(
        self,
        baseline_load: np.ndarray,
        *,
        half_life: float = 8.0,
        min_queries: int = 64,
    ):
        base = np.asarray(baseline_load, dtype=np.float64)
        self.decayed = base.copy()
        self.half_life = float(half_life)
        self.min_queries = int(min_queries)
        self.observed_queries = 0
        self.observations = 0
        self._alpha = 0.5 ** (1.0 / max(self.half_life, 1e-9))
        # groups with any observed traffic since the last replan
        # evaluation — the candidate set compute_plan_patch needs
        self._dirty = np.zeros(base.shape[0], dtype=bool)

    @property
    def ready(self) -> bool:
        """Whether enough traffic has been seen to trust the estimate."""
        return self.observed_queries >= self.min_queries

    def observe(self, group_loads: np.ndarray, num_queries: int) -> None:
        """Folds one flush's ``(G,)`` per-group loads into the decayed
        estimate; ``num_queries`` (the flush's queries) gates ``ready``."""
        loads = np.asarray(group_loads, dtype=np.float64)
        if loads.shape != self.decayed.shape:
            raise ValueError(
                f"observation has shape {loads.shape}, tracker has "
                f"{self.decayed.shape}"
            )
        self.decayed = self._alpha * self.decayed + loads
        self._dirty |= loads > 0.0
        self.observed_queries += int(num_queries)
        self.observations += 1

    def load(self) -> np.ndarray:
        """Snapshot of the decayed ``(G,)`` load estimate."""
        return self.decayed.copy()

    def drifted_groups(self) -> np.ndarray:
        """Fused group ids with observed traffic since the last
        :meth:`reset_drifted` — the exact ``candidates`` set for
        :func:`~repro_torch.dist.replan.compute_plan_patch`: every other
        group's estimate has only decayed (DESIGN.md §11)."""
        return np.nonzero(self._dirty)[0]

    def reset_drifted(self) -> None:
        """Clears the drift marks once a replan evaluation consumed them."""
        self._dirty[:] = False

    def mark_drifted(self, group_ids) -> None:
        """Re-marks groups as drift candidates (deferred promotions and
        dropped patches keep their Eq.-1 target status alive)."""
        ids = np.asarray(group_ids, dtype=np.int64)
        if ids.size:
            self._dirty[ids] = True

    def drift_from(self, reference_load, segments=None) -> float:
        """Total-variation distance to a reference load, both normalized.

        Args:
          reference_load: ``(G,)`` load the live plan was placed for.
          segments: optional ``(start, end)`` group-id ranges (one per
            table); the distance is then taken per segment and the
            maximum returned, so a table that simply receives no traffic
            (its decayed estimate a scaled copy of its reference) does
            not register as drift.

        Returns 0.0 for segments of zero mass on either side.
        """
        q = np.asarray(reference_load, dtype=np.float64)
        if segments is None:
            segments = [(0, self.decayed.shape[0])]
        drift = 0.0
        for start, end in segments:
            p_s = self.decayed[start:end]
            q_s = q[start:end]
            ps, qs = float(p_s.sum()), float(q_s.sum())
            if ps <= 0.0 or qs <= 0.0:
                continue
            drift = max(
                drift, 0.5 * float(np.abs(p_s / ps - q_s / qs).sum())
            )
        return drift


def _tensor_bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a uint8 array, for any dtype (a bf16
    tensor has no NumPy view of its own)."""
    return t.contiguous().view(torch.uint8).numpy()


class LoadObservationCache:
    """Content-keyed LRU memo for the per-flush load observation.

    Keyed on a BLAKE2b digest of the batch's arrays (shapes and dtypes
    included): a :class:`~repro_torch.core.reduction.FusedActivations`'
    tile ids and popcounts, or a dense compiled batch's ``tile_ids`` and
    ``bitmaps``.  Two flushes of the same shape but different queries
    have different loads, while a replayed flush with byte-identical
    schedules has identical loads.  A miss runs the real
    :func:`~repro_torch.core.reduction.activation_group_loads` or
    :func:`~repro_torch.core.reduction.fused_group_loads`.

    Returned arrays are shared with the cache — callers must not mutate
    them (``DriftTracker.observe`` does not).
    """

    def __init__(self, maxsize: int = 64):
        self.maxsize = int(maxsize)
        self.hits = 0
        self.misses = 0
        self._memo: collections.OrderedDict = collections.OrderedDict()

    @staticmethod
    def _key(obs) -> bytes:
        if isinstance(obs, FusedActivations):
            arrays = [torch.from_numpy(np.ascontiguousarray(a))
                      for a in (obs.tile_ids, obs.rows)]
        else:
            arrays = [obs.tile_ids, obs.bitmaps]
        h = hashlib.blake2b(digest_size=16)
        h.update(repr([(tuple(a.shape), str(a.dtype)) for a in arrays]).encode())
        for a in arrays:
            h.update(_tensor_bytes(a))
        return h.digest()

    def loads(self, obs, tile_group: np.ndarray, num_groups: int) -> np.ndarray:
        """Memoized loads of ``obs``, a :class:`~repro_torch.core.
        reduction.FusedActivations` or a dense compiled batch."""
        key = self._key(obs)
        hit = self._memo.get(key)
        if hit is not None:
            self.hits += 1
            self._memo.move_to_end(key)
            return hit
        self.misses += 1
        observe = (activation_group_loads if isinstance(obs, FusedActivations)
                   else fused_group_loads)
        out = observe(obs, tile_group, num_groups)
        self._memo[key] = out
        while len(self._memo) > self.maxsize:
            self._memo.popitem(last=False)
        return out
