"""Baseline pipelines the paper compares against, as one-call helpers.

Each helper takes (graph or num_rows, queries, batch context) and returns
a (layout, SimReport) pair, so benchmarks and tests compare apples to
apples:

  * ``naive``      — itemID-order mapping, no replication, static ADC.
  * ``frequency``  — frequency-sorted mapping [33], no replication, static ADC.
  * ``nmars``      — nMARS [24]: naive mapping, parallel lookup + sequential
                     aggregation, static ADC.
  * ``recross``    — full ReCross: correlation grouping + Eq.-1 replication
                     + dynamic switching.

A copy of ``repro.core.baselines``; the port never imports the JAX
package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.cooccurrence import CoOccurrenceGraph, build_cooccurrence
from repro_torch.core.grouping import (
    correlation_aware_grouping,
    frequency_grouping,
    naive_grouping,
)
from repro_torch.core.mapping import CrossbarLayout, build_layout
from repro_torch.core.replication import plan_replication
from repro_torch.core.simulator import SimReport, simulate_batch, simulate_nmars_baseline
from repro_torch.core.energy import ReRAMCostModel, DEFAULT_RERAM


def recross_pipeline(
    graph: CoOccurrenceGraph,
    queries: Sequence[Sequence[int]],
    *,
    group_size: int = 64,
    dim: int = 64,
    batch_size: int | None = None,
    area_budget_ratio: float | None = None,
    model: ReRAMCostModel = DEFAULT_RERAM,
    replication_scheme: str = "log",
    dynamic_switching: bool = True,
) -> Tuple[CrossbarLayout, SimReport]:
    grouping = correlation_aware_grouping(graph, group_size)
    plan = plan_replication(
        grouping,
        graph.freq,
        batch_size or len(queries),
        area_budget_ratio=area_budget_ratio,
        scheme=replication_scheme,
    )
    layout = build_layout(grouping, plan, dim)
    report = simulate_batch(
        layout, queries, model=model, dynamic_switching=dynamic_switching
    )
    return layout, report


def naive_pipeline(
    num_rows: int,
    queries: Sequence[Sequence[int]],
    *,
    group_size: int = 64,
    dim: int = 64,
    model: ReRAMCostModel = DEFAULT_RERAM,
) -> Tuple[CrossbarLayout, SimReport]:
    grouping = naive_grouping(num_rows, group_size)
    plan = plan_replication(grouping, np.zeros(num_rows), 1, scheme="none")
    layout = build_layout(grouping, plan, dim)
    report = simulate_batch(
        layout, queries, model=model, dynamic_switching=False, balance_replicas=False
    )
    return layout, report


def frequency_pipeline(
    graph: CoOccurrenceGraph,
    queries: Sequence[Sequence[int]],
    *,
    group_size: int = 64,
    dim: int = 64,
    model: ReRAMCostModel = DEFAULT_RERAM,
) -> Tuple[CrossbarLayout, SimReport]:
    grouping = frequency_grouping(graph, group_size)
    plan = plan_replication(grouping, graph.freq, 1, scheme="none")
    layout = build_layout(grouping, plan, dim)
    report = simulate_batch(
        layout, queries, model=model, dynamic_switching=False, balance_replicas=False
    )
    return layout, report


def nmars_pipeline(
    num_rows: int,
    queries: Sequence[Sequence[int]],
    *,
    group_size: int = 64,
    dim: int = 64,
    model: ReRAMCostModel = DEFAULT_RERAM,
) -> Tuple[CrossbarLayout, SimReport]:
    grouping = naive_grouping(num_rows, group_size)
    plan = plan_replication(grouping, np.zeros(num_rows), 1, scheme="none")
    layout = build_layout(grouping, plan, dim)
    report = simulate_nmars_baseline(layout, queries, model=model)
    return layout, report
