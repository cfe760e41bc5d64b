"""Cycle-level crossbar scheduler / cost simulator.

Replays a query batch against a :class:`~repro_torch.core.mapping.CrossbarLayout`
and charges every crossbar activation to the
:class:`~repro_torch.core.energy.ReRAMCostModel`.  This is the NeuroSIM-role
component: it produces the paper's evaluation metrics —

  * completion time of the batch (with inter-query contention: a tile can
    serve one activation at a time; replicas serve in parallel — the
    §III-C stall-cycle story),
  * total energy,
  * crossbar-activation counts (Fig. 9),
  * READ/MAC mode mix (Fig. 6),

for ReCross and for the baselines (naïve mapping, frequency-based mapping
[33], nMARS-style static-ADC reduction [24]).

The batch replay is fully vectorized: queries are compiled once into the
sparse :class:`~repro_torch.core.mapping.ActivationSet`, per-activation
latencies/energies come from the (affine) cost-model formulas evaluated on
whole arrays, and tile busy time / total energy are charged with
``np.ufunc.at`` scatters in the same (query, tile) order the original
Python loop used — so the accumulated floats are bit-identical to the loop
(kept as :func:`_reference_simulate_batch` for the equivalence tests) and
100k-query histories replay in milliseconds instead of minutes.

A NumPy copy of ``repro.core.simulator``; the port never imports the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.energy import ReRAMCostModel, DEFAULT_RERAM
from repro_torch.core.mapping import (
    CrossbarLayout,
    compile_activations,
    _reference_query_tile_bitmaps,
)


@dataclasses.dataclass
class SimReport:
    """Batch-level simulation result."""

    completion_time_ns: float
    energy_pj: float
    activations: int
    read_activations: int
    mac_activations: int
    stall_ns: float
    per_query_tiles: np.ndarray      # (batch,) tiles activated by each query
    mean_active_rows: float

    @property
    def read_fraction(self) -> float:
        return self.read_activations / max(self.activations, 1)

    def speedup_over(self, other: "SimReport") -> float:
        return other.completion_time_ns / max(self.completion_time_ns, 1e-12)

    def energy_efficiency_over(self, other: "SimReport") -> float:
        return other.energy_pj / max(self.energy_pj, 1e-12)


def _activation_costs(
    rows: np.ndarray,
    model: ReRAMCostModel,
    dynamic_switching: bool,
    switch_threshold: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(latency_ns, energy_pj, read_mask) per activation, vectorized.

    The cost-model event methods are affine in ``active_rows``, so calling
    them on int64 arrays reproduces the scalar per-event arithmetic
    exactly (same IEEE operations elementwise as the reference loop).
    """
    rows = np.asarray(rows, dtype=np.int64)
    if dynamic_switching:
        read_mask = rows <= switch_threshold
        lat_read, e_read = model.crossbar_read_event()
        lat_mac, e_mac = model.crossbar_mac_event(rows)
        lat = np.where(read_mask, lat_read * rows, lat_mac)
        energy = np.where(read_mask, e_read * rows, e_mac)
    else:
        read_mask = np.zeros(rows.shape, dtype=bool)
        lat, energy = model.crossbar_static_mac_event(rows)
        lat = np.broadcast_to(np.float64(lat), rows.shape)
    return lat, energy, read_mask


def simulate_batch(
    layout: CrossbarLayout,
    queries: Sequence[Sequence[int]],
    *,
    model: ReRAMCostModel = DEFAULT_RERAM,
    dynamic_switching: bool = True,
    balance_replicas: bool = True,
    switch_threshold: int = 1,
) -> SimReport:
    """Simulates one batch of embedding-reduction queries.

    Timing model: all queries of a batch are issued simultaneously
    (batch-level inference).  Each activated tile serves its queue of
    activations serially; distinct tiles (including replicas of the same
    group) operate in parallel.  Batch completion time is the max over
    tiles of the tile's busy time — queue imbalance therefore shows up as
    stalls, which is exactly what Eq.-1 replication attacks.
    """
    acts = compile_activations(layout, queries, balance_replicas=balance_replicas)
    num_tiles = layout.num_tiles
    rows = acts.act_rows
    activations = acts.num_activations

    lat, energy_per_act, read_mask = _activation_costs(
        rows, model, dynamic_switching, switch_threshold
    )

    tile_busy_ns = np.zeros(num_tiles, dtype=np.float64)
    # ufunc.at applies repeated indices sequentially in array order; the
    # activation list is (query, tile)-sorted — the same order the scalar
    # loop charged tiles in, so per-tile sums match it bit for bit.
    np.add.at(tile_busy_ns, acts.act_tile, lat)
    energy_acc = np.zeros(1, dtype=np.float64)
    np.add.at(energy_acc, np.zeros(activations, dtype=np.intp), energy_per_act)

    reads = int(read_mask.sum())
    completion = float(tile_busy_ns.max()) if activations else 0.0
    # stall = extra serialization beyond a perfectly balanced schedule
    ideal = float(tile_busy_ns.sum()) / max(num_tiles, 1)
    per_query_tiles = acts.per_query_tiles()

    return SimReport(
        completion_time_ns=completion,
        energy_pj=float(energy_acc[0]),
        activations=activations,
        read_activations=reads,
        mac_activations=activations - reads,
        stall_ns=max(completion - ideal, 0.0),
        per_query_tiles=per_query_tiles,
        mean_active_rows=int(rows.sum()) / max(activations, 1),
    )


def _reference_simulate_batch(
    layout: CrossbarLayout,
    queries: Sequence[Sequence[int]],
    *,
    model: ReRAMCostModel = DEFAULT_RERAM,
    dynamic_switching: bool = True,
    balance_replicas: bool = True,
    switch_threshold: int = 1,
) -> SimReport:
    """Original per-activation Python loop (equivalence oracle)."""
    bitmaps, counts = _reference_query_tile_bitmaps(
        layout, queries, balance_replicas=balance_replicas
    )
    batch, num_tiles = counts.shape

    tile_busy_ns = np.zeros(num_tiles, dtype=np.float64)
    energy = 0.0
    activations = 0
    reads = 0
    macs = 0
    active_rows_sum = 0

    q_idx, t_idx = np.nonzero(counts)
    for q, t in zip(q_idx, t_idx):
        rows = int(counts[q, t])
        activations += 1
        active_rows_sum += rows
        if dynamic_switching and rows <= switch_threshold:
            # READ mode: k activated rows are read out serially through the
            # low-resolution ADC path (k=1 in the paper; thresholds >1 are
            # the beyond-paper "multi-read" policy, see §Perf notes)
            lat, e = model.crossbar_read_event()
            lat, e = lat * rows, e * rows
            reads += 1
        elif dynamic_switching:
            lat, e = model.crossbar_mac_event(rows)
            macs += 1
        else:
            lat, e = model.crossbar_static_mac_event(rows)
            macs += 1
        tile_busy_ns[t] += lat
        energy += e

    completion = float(tile_busy_ns.max()) if activations else 0.0
    ideal = float(tile_busy_ns.sum()) / max(num_tiles, 1)
    per_query_tiles = (counts > 0).sum(axis=1).astype(np.int64)

    return SimReport(
        completion_time_ns=completion,
        energy_pj=energy,
        activations=activations,
        read_activations=reads,
        mac_activations=macs,
        stall_ns=max(completion - ideal, 0.0),
        per_query_tiles=per_query_tiles,
        mean_active_rows=active_rows_sum / max(activations, 1),
    )


def simulate_cpu_baseline(
    queries: Sequence[Sequence[int]],
    *,
    model: ReRAMCostModel = DEFAULT_RERAM,
    parallel_lanes: int = 8,
) -> SimReport:
    """CPU gather-sum baseline (Fig. 11): DRAM row fetches + host adds.

    ``parallel_lanes`` models the memory-level parallelism of a desktop
    CPU's load queue; energy is charged per fetched row regardless.
    ``mean_active_rows`` reports the true mean unique rows fetched per
    query (the Fig. 11 comparison axis), not a placeholder.
    """
    per_query = np.fromiter(
        (len(set(int(r) for r in q)) for q in queries), np.int64, len(queries)
    )
    lane_busy = np.zeros(parallel_lanes, dtype=np.float64)
    energy = 0.0
    for rows in per_query:
        lat, e = model.cpu_reduction_event(int(rows))
        lane = int(np.argmin(lane_busy))
        lane_busy[lane] += lat
        energy += e
    total_rows = int(per_query.sum())
    return SimReport(
        completion_time_ns=float(lane_busy.max()),
        energy_pj=energy,
        activations=total_rows,
        read_activations=total_rows,
        mac_activations=0,
        stall_ns=0.0,
        per_query_tiles=per_query,
        mean_active_rows=float(per_query.mean()) if per_query.size else 0.0,
    )


def simulate_nmars_baseline(
    layout: CrossbarLayout,
    queries: Sequence[Sequence[int]],
    *,
    model: ReRAMCostModel = DEFAULT_RERAM,
    crossbars_per_adder: int = 8,
) -> SimReport:
    """nMARS-style [24] baseline: parallel in-memory lookup, then
    aggregation of per-crossbar partial sums over a hierarchical adder
    fabric (one adder lane per ``crossbars_per_adder`` crossbars, serial
    within a lane), static full-resolution ADC, no replication balancing."""
    rep = simulate_batch(
        layout,
        queries,
        model=model,
        dynamic_switching=False,
        balance_replicas=False,
    )
    lanes = max(layout.num_tiles // crossbars_per_adder, 1)
    transfers = float(rep.per_query_tiles.sum())
    agg_ns = transfers * model.bus_cycle_ns / lanes
    agg_pj = transfers * model.bus_energy_pj
    return dataclasses.replace(
        rep,
        completion_time_ns=rep.completion_time_ns + agg_ns,
        energy_pj=rep.energy_pj + agg_pj,
    )
