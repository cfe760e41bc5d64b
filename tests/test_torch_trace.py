"""``repro_torch.core.trace``: the serve path's and the plan build's spans
and counters, on a CPU server.

Off, nothing is recorded.  On, every span is recorded where its work
happens, ``serve.compile`` equals the server's own host compile seconds,
the spans nest under ``serve.request`` in a profiler's trace (and call no
``record_function`` outside one), and the slot counters equal a
brute-force count of the kernel's READ rule and of the ones its MAC slots
sum.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import reduction as tred
from repro_torch.core import trace
from repro_torch.data.synthetic import zipf_queries
from repro_torch.serve import ShardedEmbeddingServer, TierConfig

ROWS = {"a": 192, "b": 512}
COMPILE = ("compile.activations", "compile.shard_block", "compile.upload")
PLAN = ("plan.cooccurrence", "plan.grouping", "plan.replication", "plan.placement",
        "plan.image")


@pytest.fixture(autouse=True)
def tracing():
    """Each test starts with empty totals; the switch is restored after."""
    was = trace.enabled()
    trace.reset()
    yield
    trace.set_enabled(was)
    trace.reset()


def _server(**kw):
    gen = torch.Generator().manual_seed(0)
    tables = {n: torch.randn((r, 128), generator=gen) for n, r in ROWS.items()}
    histories = {n: zipf_queries(r, 64, 6.0, seed=10 + i)
                 for i, (n, r) in enumerate(ROWS.items())}
    kw = {"num_shards": 2, "q_block": 4, "group_size": 16, "batch_size": 12, **kw}
    return ShardedEmbeddingServer(tables, histories, device="cpu", **kw)


def _request(seed):
    return {n: zipf_queries(r, 24, 6.0, seed=seed + i) for i, (n, r) in enumerate(ROWS.items())}


def test_off_records_nothing():
    trace.set_enabled(False)
    assert trace.span("x") is trace.span("y", 3)
    with trace.span("x") as s:
        s.record(1.0)
    trace.count("slots", 5)
    server = _server()
    server.serve(_request(1))
    assert trace.totals() == {"spans": {}, "counters": {}}


def test_on_records_every_span_where_its_work_happens():
    trace.set_enabled(True)
    server = _server()
    got = trace.totals()["spans"]
    assert {n: got[n][1] for n in PLAN} == {
        "plan.cooccurrence": 2, "plan.grouping": 2, "plan.replication": 2,
        "plan.placement": 1, "plan.image": 1}
    assert set(got) == set(PLAN)
    trace.reset()
    for seed in (1, 2, 3):
        server.serve(_request(seed))
    got = trace.totals()
    calls = {n: c for n, (_, c) in got["spans"].items()}
    # a CPU server has no event to wait for, issues no host-to-device copy
    # and expands no bitmap on a card; the dense compile's stages are gone
    assert calls == {"serve.request": 3, "serve.compile": 3, "compile.activations": 6,
                     "compile.shard_block": 3, "compile.upload": 3, "serve.dispatch": 3}
    assert set(got["counters"]) == {"slots", "read_slots", "mac_ones"}
    assert got["counters"].get("expand_entries", 0) == 0
    assert 0 < got["counters"]["read_slots"] <= got["counters"]["slots"]
    assert got["counters"]["mac_ones"] > 0


def test_tiers_place_once_a_build():
    trace.set_enabled(True)
    _server(tiers=TierConfig(capacity_frac=0.5))
    calls = {n: c for n, (_, c) in trace.totals()["spans"].items()}
    assert calls["plan.placement"] == 1 and calls["plan.image"] == 1


def test_serve_compile_is_the_servers_host_compile_time():
    trace.set_enabled(True)
    server = _server()
    trace.reset()
    for seed in range(4):
        server.serve(_request(seed))
        spans = trace.totals()["spans"]
        compile_s = spans["serve.compile"][0]
        assert abs(compile_s - server.report()["serve"]["host_compile_s"]) <= 1e-9
        assert sum(spans[n][0] for n in COMPILE) <= compile_s


def test_spans_nest_under_the_request_in_a_profiler_trace(monkeypatch):
    trace.set_enabled(True)
    server = _server()
    args = []
    record_function = torch.profiler.record_function

    def recording(name, a=None):
        args.append((name, a))
        return record_function(name, a)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    server.serve(_request(1))
    # no profiler, no record_function: the totals alone
    assert args == [] and trace.totals()["spans"]["serve.request"][1] == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        server.serve(_request(2))
        server.serve(_request(3))
    assert [a for n, a in args if n == "serve.request"] == ["2", "3"]
    program = [e for e in prof.events()
               if e.name.split(".")[0] in ("serve", "compile") and e.name != "serve.request"]
    assert {e.name for e in program} == {"serve.compile", "serve.dispatch", *COMPILE}
    for e in program:
        parent = e.cpu_parent
        while parent is not None and parent.name != "serve.request":
            parent = parent.cpu_parent
        assert parent is not None, e.name
    inside = {e.name: e.cpu_parent.name for e in program if e.name in COMPILE}
    assert inside == dict.fromkeys(COMPILE, "serve.compile")


def _brute_force(sbq):
    """Non-padding slots, those with at most one nonzero entry, and the
    nonzero entries of the others."""
    held = (sbq.bitmaps != 0).sum((-2, -1))
    real = sbq.tile_ids >= 0
    return (int(real.sum()), int((real & (held <= 1)).sum()),
            int(held[real & (held > 1)].sum()))


def _ones(sbq):
    """Every nonzero entry of the non-padding slots."""
    held = (sbq.bitmaps != 0).sum((-2, -1))
    return int(held[sbq.tile_ids >= 0].sum())


@pytest.mark.parametrize("switch", [True, False])
def test_slot_counters_equal_a_brute_force_count(switch):
    trace.set_enabled(True)
    server = _server(dynamic_switch=switch)
    seen = []
    compile_batch = server._compile_batch

    def capturing(*a, **kw):
        out = compile_batch(*a, **kw)
        # counted now: the bitmap is the server's kept-zeroed buffer, which
        # the next compile clears
        seen.append((out[1].slot_counts, _brute_force(out[1]), _ones(out[1])))
        return out

    server._compile_batch = capturing
    trace.reset()
    for seed in (1, 2):
        server.serve(_request(seed))
    slots = sum(brute[0] for _, brute, _ in seen)
    single = sum(brute[1] for _, brute, _ in seen)
    multi_ones = sum(brute[2] for _, brute, _ in seen)
    ones = sum(n for _, _, n in seen)
    assert [counted for counted, _, _ in seen] == [brute for _, brute, _ in seen]
    assert 0 < single < slots and 0 < multi_ones < ones
    counters = trace.totals()["counters"]
    # with the switch off every slot takes the MAC path, and sums its ones
    assert counters == {"slots": slots, "read_slots": single if switch else 0,
                        "mac_ones": multi_ones if switch else ones}


def test_slots_are_not_counted_while_off():
    server = _server()
    offsets = [server.plan.tables[i].tile_offset for i in range(len(server.names))]
    cqs = [tred.offset_compiled_queries(
        tred.compile_queries(server.layouts[i], _request(1)[n], replica_block=4, device="cpu"),
        offsets[i]) for i, n in enumerate(server.names)]
    fused, _ = tred.concat_compiled_queries(cqs, 4)
    acts = [tred.compile_activations(server.layouts[i], _request(1)[n], replica_block=4)
            for i, n in enumerate(server.names)]

    def both():
        return (tred.shard_block_queries(fused, server.plan, 4),
                tred.shard_block_activations(acts, offsets, server.plan, 4, device="cpu")[0])

    trace.set_enabled(False)
    assert [sbq.slot_counts for sbq in both()] == [None, None]
    trace.set_enabled(True)
    for sbq in both():
        assert sbq.slot_counts == _brute_force(sbq)
