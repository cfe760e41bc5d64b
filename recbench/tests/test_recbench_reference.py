"""The plain reference, and its agreement with the port's server at a
small size on the CPU."""

import math

import numpy as np
import pytest
import torch

from recbench import reference


def test_reduce_bags_is_a_gather_and_sum():
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(100, 64, generator=gen)
    bags = [np.array([3, 1, 4]), np.array([99]), np.array([5, 5, 9])]
    got = reference.reduce_bags(table, bags)
    for b, row in zip(bags, got):
        want = table[sorted(set(b.tolist()))].to(torch.float64).sum(0)
        assert torch.allclose(row, want, rtol=0, atol=1e-12)


def _tables_and_requests(rows=4096, dim=64, width=128, n_tables=2, n_requests=3, bag=30):
    rng = np.random.default_rng(1)
    gen = torch.Generator().manual_seed(1)
    full = torch.zeros(n_tables, rows, width)
    full[:, :, :dim] = torch.randn(n_tables, rows, dim, generator=gen)
    names = [f"t{t}" for t in range(n_tables)]
    requests = [{n: [np.unique(rng.integers(0, rows, bag)) for _ in range(16)] for n in names}
                for _ in range(n_requests)]
    history = {n: [np.unique(rng.integers(0, rows, bag)) for _ in range(1500)] for n in names}
    return full, names, requests, history


def test_reference_agrees_with_the_port_server():
    from repro_torch.serve.sharded import ShardedEmbeddingServer

    full, names, requests, history = _tables_and_requests()
    server = ShardedEmbeddingServer({n: full[t] for t, n in enumerate(names)}, history,
                                    group_size=16, device="cpu")
    outputs = [server.serve(r) for r in requests]
    logical = {n: full[t, :, :64] for t, n in enumerate(names)}
    readings = reference.compare(logical, requests, outputs, 128)
    assert readings["failed_requests"] == 0 and readings["pad_nonzero"] == 0
    assert readings["max_abs_err"] < 1e-4


def test_compare_counts_what_is_wrong():
    full, names, requests, _ = _tables_and_requests(n_requests=4)
    logical = {n: full[t, :, :64] for t, n in enumerate(names)}
    good = [{n: torch.cat([reference.reduce_bags(logical[n], r[n]).float(),
                           torch.zeros(len(r[n]), 64)], 1) for n in names} for r in requests]
    assert reference.compare(logical, requests, good, 128)["max_abs_err"] < 1e-5
    bad = [dict(o) for o in good]
    bad[0] = None                                            # raised
    bad[1] = {names[0]: good[1][names[0]]}                   # a table missing
    bad[2][names[1]] = good[2][names[1]][:8]                 # half the rows
    bad[3][names[0]] = good[3][names[0]].clone()
    bad[3][names[0]][5, 70] = 1.0                            # padding written
    bad[3][names[0]][4, 3] = float("nan")                    # a value lost
    r = reference.compare(logical, requests, bad, 128)
    assert r["failed_requests"] == 3
    assert r["pad_nonzero"] == 1
    assert math.isinf(r["max_abs_err"])
    assert not reference.judge(r, {"failed_requests": 0, "max_abs_err": 1e-3, "pad_nonzero": 0})


@pytest.mark.parametrize("reading,limit,ok", [(0.0, 0, True), (1e-4, 1e-3, True),
                                              (2e-3, 1e-3, False), (float("nan"), 1, False)])
def test_judge(reading, limit, ok):
    assert reference.judge({"x": reading}, {"x": limit}) is ok
