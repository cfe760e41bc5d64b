"""The frozen work count reads the queries and widths alone: plans of one
table that differ give one count."""

import numpy as np
import pytest

from recbench import work


def test_hand_count():
    request = {"t0": [np.array([1, 2]), np.array([2, 3])], "t1": [np.array([7])]}
    nbytes, ops = work.request_work(request, 64, "float32")
    # t0: 3 distinct rows, 4 ids, 2 outputs; t1: 1 row, 1 id, 1 output
    assert nbytes == (3 * 64 * 4 + 4 * 4 + 2 * 64 * 4) + (64 * 4 + 4 + 64 * 4)
    assert ops == 5 * 64
    assert work.least_time_s(nbytes, ops, "float32") == pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("group_sizes", [(16, 32), (16, 64)])
def test_two_plans_one_count(group_sizes):
    from repro_torch.core import build_cooccurrence, correlation_aware_grouping
    from repro_torch.core.mapping import build_layout
    from repro_torch.core.reduction import compile_queries, reduction_flops
    from repro_torch.core.replication import plan_replication

    rng = np.random.default_rng(0)
    rows = 2048
    history = [np.unique(rng.integers(0, rows, rng.integers(2, 40))) for _ in range(600)]
    queries = history[:64]
    counts, port_flops = set(), set()
    for g in group_sizes:
        graph = build_cooccurrence(history, rows)
        grouping = correlation_aware_grouping(graph, g)
        layout = build_layout(grouping, plan_replication(grouping, graph.freq, 256), 128)
        cq = compile_queries(layout, queries, device="cpu")
        port_flops.add(int(reduction_flops(cq.bitmaps, 128, True)))
        counts.add(work.request_work({"t0": queries}, 64, "float32"))
    assert len(counts) == 1
    # the port's own count moves with the plan: the reason it is not the yardstick
    assert len(port_flops) == 2
