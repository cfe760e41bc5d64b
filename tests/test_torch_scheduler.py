"""The async flush engine of the port: ``repro_torch.serve``'s scheduler,
``BlockUnionTracker``, retry policy and async ``ShardedEmbeddingServer``
on the CPU against ``repro.serve``'s (``mesh=None``).

Mirrors ``tests/test_scheduler.py`` apart from its two ``shard_map``
subprocess tests.  Integer-valued tables make every partial sum exact,
so drained rows must be bit-identical (``assert_array_equal``) to the
reference server under the same policy and to a host gather+sum.
Threaded runs assert only on what is deterministic: the rows and their
merge order are a function of what was submitted, never of thread
timing.
"""

import functools

import numpy as np
import pytest
import torch

from repro.core import BlockUnionTracker as JaxTracker
from repro.data import zipf_queries
from repro.serve import FlushPolicy as JaxPolicy
from repro.serve import RetryPolicy as JaxRetry
from repro.serve import ShardedEmbeddingServer as JaxServer
from repro.serve.faults import ErrorLedger as JaxLedger
from repro.serve.faults import latency_percentiles as jax_percentiles
from repro_torch.convert import tables_from_numpy
from repro_torch.core import (
    BlockUnionTracker,
    build_cooccurrence,
    build_layout,
    compile_queries,
    correlation_aware_grouping,
    plan_replication,
    shard_block_queries,
)
from repro_torch.dist.shard_plan import build_fused_image, plan_shards
from repro_torch.kernels._build import KernelError
from repro_torch.kernels.sharded import crossbar_reduce_sharded
from repro_torch.serve import (
    POOL,
    SEQ_STRIDE,
    ErrorLedger,
    FlushPolicy,
    FlushTimeout,
    RetryPolicy,
    ShardedEmbeddingServer as TorchServer,
)
from repro_torch.serve.faults import latency_percentiles
from repro_torch.serve.sharded import _InFlight

DIM = 128
ROWS = {"a": 160, "b": 320}
ASYNC_KINDS = ("per-shard", "deadline", "owner-set")
# stats that depend only on what was submitted, under the inline engine
DETERMINISTIC_ASYNC_FIELDS = (
    "shard_flushes", "participant_sizes", "batches", "deadline_flushes",
    "queries", "blocks", "grid_cells_per_shard", "max_grid_cells_per_flush",
    "max_shard_width", "combine_bytes", "in_flight_peak", "barrier_flushes",
)
LEDGER_FIELDS = ("retries", "backoff_s", "bisections", "quarantined",
                 "quarantined_by_producer", "degraded_flushes",
                 "timed_out_flushes", "recoveries")


def _int_table(rows, seed):
    """Integer-valued f32 table: partial sums are exact in float32."""
    return np.random.default_rng(seed).integers(-8, 9, size=(rows, DIM)).astype(np.float32)


TABLES = {n: _int_table(r, 11 + i) for i, (n, r) in enumerate(ROWS.items())}
HISTORIES = {n: zipf_queries(r, 48, 5.0, seed=13 + i) for i, (n, r) in enumerate(ROWS.items())}


def _replay():
    """Skewed two-table interleave: ``a`` arrives ~2x as often as ``b``."""
    streams = {"a": zipf_queries(ROWS["a"], 30, 5.0, seed=15),
               "b": zipf_queries(ROWS["b"], 17, 5.0, seed=16)}
    replay, ia, ib = [], 0, 0
    for i in range(len(streams["a"]) + len(streams["b"])):
        if (i % 3 < 2 and ia < len(streams["a"])) or ib >= len(streams["b"]):
            replay.append(("a", streams["a"][ia]))
            ia += 1
        else:
            replay.append(("b", streams["b"][ib]))
            ib += 1
    return replay, streams


REPLAY, STREAMS = _replay()


def _oracle(table, queries):
    """Host gather+sum over each query's distinct rows."""
    return np.stack([
        table[np.unique(np.asarray(q, np.int64))].sum(axis=0) if len(q)
        else np.zeros(table.shape[1], table.dtype)
        for q in queries
    ])


def _kw(num_shards, **kw):
    return {"num_shards": num_shards, "q_block": 4, "group_size": 16, "batch_size": 8, **kw}


def _port(tables=TABLES, histories=HISTORIES, **kw):
    return TorchServer(tables_from_numpy(tables, "cpu"), histories, device="cpu", **kw)


def _run(server, replay=REPLAY):
    """Submits ``replay``, collects every row (submit returns + the final
    flush), closes; returns ``{table: rows}`` as NumPy."""
    outs = {}
    for name, q in replay:
        for n, o in server.submit(name, q).items():
            outs.setdefault(n, []).append(np.asarray(o))
    for n, o in server.flush().items():
        outs.setdefault(n, []).append(np.asarray(o))
    server.close()
    return {n: np.concatenate(v) for n, v in outs.items()}


@functools.cache
def _reference_run(policy, num_shards):
    """The JAX server's rows and stats under ``policy`` (inline engine)."""
    srv = JaxServer(TABLES, HISTORIES, mesh=None, **_kw(num_shards, flush_policy=policy))
    rows = _run(srv)
    return rows, srv.stats.summary()


# ------------------------------------------------------- scheduler parity --


def _schedulers(kind, num_shards, owner_set_max):
    kw = _kw(num_shards, flush_policy=kind, owner_set_max=owner_set_max)
    ref = JaxServer(TABLES, HISTORIES, mesh=None, **kw)
    port = _port(**kw)
    return ref.scheduler, port.scheduler


@pytest.mark.parametrize("owner_set_max", [None, 2])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("kind", ASYNC_KINDS)
def test_scheduler_matches_reference(kind, num_shards, owner_set_max):
    """route/push/due_reason/fill/take/requeue/state equal the
    reference's over one seeded stream."""
    ref, port = _schedulers(kind, num_shards, owner_set_max)
    requeued = False
    for seq, (table, q) in enumerate(REPLAY):
        (h_ref, g_ref), (h_port, g_port) = ref.route(table, q), port.route(table, q)
        assert h_ref == h_port
        np.testing.assert_array_equal(g_ref, g_port)
        assert ref.push(table, seq, q) == port.push(table, seq, q)
        assert list(ref._pending) == list(port._pending)
        for home in ref._pending:
            assert ref.due_reason(home) == port.due_reason(home)
            assert ref.fill(home) == port.fill(home)
        due = ref.due_homes()
        assert due == port.due_homes()
        for home in due:
            tick = ref.first_tick(home)
            assert port.first_tick(home) == tick
            taken_ref, taken_port = ref.take(home), port.take(home)
            assert taken_ref == taken_port
            if not requeued:
                # a failed dispatch puts the batch back at the front
                ref.requeue(home, taken_ref[0], first_tick=tick)
                port.requeue(home, taken_port[0], first_tick=tick)
                assert ref.fill(home) == port.fill(home)
                assert ref.take(home) == port.take(home)
                requeued = True
    assert ref.homes_with_pending() == port.homes_with_pending()
    assert ref.pending_total() == port.pending_total()
    assert ref.state() == port.state()


def test_route_is_a_peek():
    """route() must not consume round-robin state: only push() advances."""
    srv = _port(**_kw(2, batch_size=64, batch_size_for_eq1=512,
                      flush_policy="per-shard"))
    sched = srv.scheduler
    repl_rows = np.nonzero(sched._owner_of_row["a"] < 0)[0]
    assert repl_rows.size, "the plan replicates no group of table a"
    q = [int(repl_rows[0])]
    h1, _ = sched.route("a", q)
    assert sched.route("a", q)[0] == h1, "route() consumed round-robin state"
    assert sched.push("a", 0, q) == h1
    assert sched.route("a", q)[0] == (h1 + 1) % 2


def _owner_rows(sched, table):
    """{owner shard: [row ids]} of the sharded-once rows of a table."""
    out = {}
    for r, o in enumerate(sched._owner_of_row[table]):
        if o >= 0:
            out.setdefault(int(o), []).append(r)
    return out


def test_owner_set_scheduler_routes_by_frozen_owner_set():
    """Each distinct multi-owner set is its own home and take() returns
    exactly that set as participants — the full stack only when the set
    covers the mesh."""
    sched = _port(**_kw(4, batch_size=1024, flush_policy="owner-set")).scheduler
    by_owner = _owner_rows(sched, "a")
    owners = sorted(by_owner)
    assert len(owners) == 4, owners
    a, b = owners[:2]
    q2 = [by_owner[a][0], by_owner[b][0]]
    assert sched.route("a", q2)[0] == (a, b)
    assert sched.push("a", 0, q2) == (a, b)
    entries, participants = sched.take((a, b))
    assert [e[2] for e in entries] == [q2] and participants == [a, b]
    assert sched.route("a", [by_owner[a][0]])[0] == a
    qall = [by_owner[o][0] for o in owners]
    assert sched.route("a", qall)[0] == tuple(owners)
    sched.push("a", 1, qall)
    assert sched.take(tuple(owners))[1] is None


def test_owner_set_max_pools_wide_sets():
    """Sets wider than owner_set_max pool (flushed over their owner
    union); sets within the cap keep their own home."""
    srv = _port(**_kw(4, batch_size=1024, flush_policy="owner-set", owner_set_max=2))
    assert srv.policy.owner_set_max == 2
    sched = srv.scheduler
    by_owner = _owner_rows(sched, "a")
    a, b, c = sorted(by_owner)[:3]
    assert sched.route("a", [by_owner[a][0], by_owner[b][0]])[0] == (a, b)
    q3 = [by_owner[o][0] for o in (a, b, c)]
    assert sched.route("a", q3)[0] == POOL
    sched.push("a", 0, q3)
    assert sched.take(POOL)[1] == [a, b, c]
    with pytest.raises(ValueError, match="owner_set_max"):
        FlushPolicy(kind="owner-set", owner_set_max=1)


def test_flush_policy_validation_matches_reference():
    for cls in (FlushPolicy, JaxPolicy):
        with pytest.raises(ValueError, match="unknown flush policy"):
            cls(kind="sometimes")
        with pytest.raises(ValueError, match="max_in_flight"):
            cls(kind="per-shard", max_in_flight=0)
        with pytest.raises(ValueError, match="async kind"):
            cls(kind="global", threaded=True)
        with pytest.raises(ValueError, match="deadline_s"):
            cls(kind="deadline", deadline_s=0.0)
    for kind in ("global", *ASYNC_KINDS):
        got = FlushPolicy.parse(kind, batch_size=32)
        want = JaxPolicy.parse(kind, batch_size=32)
        assert vars(got) == vars(want)
        assert got.is_async == want.is_async
    p = FlushPolicy.parse("deadline", batch_size=32)
    assert p.batch_size == 32 and p.deadline == 128 and p.handoff_depth == 256


# ----------------------------------------------------- union-fill tracker --


def test_union_tracker_matches_reference_and_compiled_grid():
    """The port's tracker equals the reference's, query by query, and
    its grid equals what shard_block_queries compiles for one shard."""
    rows = ROWS["a"]
    graph = build_cooccurrence(HISTORIES["a"], rows)
    grouping = correlation_aware_grouping(graph, 16)
    plan = plan_replication(grouping, graph.freq, 64)
    layout = build_layout(grouping, plan, DIM)
    sp = plan_shards([layout], [plan], 1, group_freqs=[grouping.group_freq(graph.freq)])
    ev = zipf_queries(rows, 13, 5.0, seed=7)
    tr, ref = BlockUnionTracker(4), JaxTracker(4)
    for q in ev:
        groups = np.unique(layout.group_of[np.unique(np.asarray(q, np.int64))]).tolist()
        tr.add(groups)
        ref.add(groups)
        assert (tr.pending, tr.fill, tr.grid_cells()) == (ref.pending, ref.fill, ref.grid_cells())
    cq = compile_queries(layout, ev, replica_block=4, device="cpu")
    sbq = shard_block_queries(cq, sp, 4, participants=[0])
    assert tr.grid_cells() == sbq.grid_cells_per_shard()
    tr.reset()
    assert tr.fill == 0 and tr.grid_cells() == 0
    with pytest.raises(ValueError):
        BlockUnionTracker(0)


def test_subset_compile_owns_each_activation_once():
    """participants= restricts the stack to the subset; summing the
    subset kernels over a partition of the batch gives the oracle."""
    rows = ROWS["a"]
    graph = build_cooccurrence(HISTORIES["a"], rows)
    grouping = correlation_aware_grouping(graph, 16)
    plan = plan_replication(grouping, graph.freq, 64)
    layout = build_layout(grouping, plan, DIM)
    table = TABLES["a"]
    sp = plan_shards([layout], [plan], 2, group_freqs=[grouping.group_freq(graph.freq)])
    images = torch.from_numpy(sp.build_shard_images(build_fused_image([layout], [table])))
    owner_of_row = sp.shard_of_group[layout.group_of]
    by_home = {0: [], 1: [], None: []}
    for q in zipf_queries(rows, 16, 5.0, seed=1):
        owners = {int(o) for o in np.unique(owner_of_row[np.unique(q)]) if o >= 0}
        by_home[owners.pop() if len(owners) == 1 else (0 if not owners else None)].append(q)
    outs, queries = [], []
    for home, qs in by_home.items():
        if not qs:
            continue
        cq = compile_queries(layout, qs, replica_block=4, device="cpu")
        sbq = shard_block_queries(cq, sp, 4, participants=None if home is None else [home])
        if home is not None:
            assert sbq.shard_ids.tolist() == [home]
        outs.append(crossbar_reduce_sharded(
            images, sbq.tile_ids, sbq.bitmaps, shard_ids=sbq.shards)[: sbq.batch].numpy())
        queries.extend(qs)
    np.testing.assert_array_equal(np.concatenate(outs), _oracle(table, queries))


# ---------------------------------------- async server ≡ reference server --


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("policy", ASYNC_KINDS)
def test_async_server_bit_identical_to_reference(policy, num_shards, threaded):
    """Drained rows equal the JAX server's under the same policy, the
    port's global flushes and the oracle; under the inline engine the
    flush accounting equals the reference's too."""
    want, ref_stats = _reference_run(policy, num_shards)
    port = _port(**_kw(num_shards, flush_policy=policy, threaded=threaded))
    got = _run(port)
    glob = _run(_port(**_kw(num_shards)))
    assert sorted(got) == sorted(want) == sorted(glob)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
        np.testing.assert_array_equal(got[n], glob[n])
        np.testing.assert_array_equal(got[n], _oracle(TABLES[n], STREAMS[n]))
    st = port.stats.summary()
    assert st["flush_policy"] == policy and st["queries"] == len(REPLAY)
    assert max(int(k) for k in st["participant_sizes"]) <= num_shards
    if not threaded:
        for key in DETERMINISTIC_ASYNC_FIELDS:
            assert st[key] == ref_stats[key], key
    assert set(st) == set(ref_stats)


def test_async_drain_orders_rows_by_submission():
    """drain() returns rows in per-table submission order even when homes
    flush out of order; a second drain returns nothing."""
    srv = _port(**_kw(2, batch_size=4, flush_policy="per-shard"))
    stream = zipf_queries(ROWS["a"], 23, 5.0, seed=22)
    for q in stream:
        srv.submit("a", q)
    out = srv.drain()
    assert out["a"].device.type == "cpu"
    np.testing.assert_array_equal(out["a"].numpy(), _oracle(TABLES["a"], stream))
    assert srv.drain() == {}


def test_sync_serve_on_async_server_is_a_barrier():
    """serve() mid-stream drains the pipeline first, then serves its own
    batch; the drain still returns every submitted row."""
    srv = _port(**_kw(2, flush_policy="per-shard", max_in_flight=4))
    stream = zipf_queries(ROWS["a"], 20, 5.0, seed=33)
    probe = zipf_queries(ROWS["a"], 5, 5.0, seed=36)
    for i, q in enumerate(stream):
        srv.submit("a", q)
        if i == 13:
            barriers = srv.stats.barrier_flushes
            got = srv.serve({"a": probe})["a"].numpy()
            np.testing.assert_array_equal(got, _oracle(TABLES["a"], probe))
            assert srv.stats.barrier_flushes == barriers + 1
            assert srv.scheduler.pending_total() == 0 and not srv._in_flight
    np.testing.assert_array_equal(srv.drain()["a"].numpy(), _oracle(TABLES["a"], stream))


def test_in_flight_peak_sampled_at_append():
    """The queue transiently holds max_in_flight + 1 entries before the
    retire loop trims it; the peak reports that transient."""
    stream = zipf_queries(ROWS["a"], 12, 5.0, seed=54)
    peaks = []
    for server in (JaxServer(TABLES, HISTORIES, mesh=None,
                             **_kw(1, batch_size=4, flush_policy="per-shard",
                                   max_in_flight=1)),
                   _port(**_kw(1, batch_size=4, flush_policy="per-shard",
                               max_in_flight=1))):
        for q in stream:
            server.submit("a", q)
        np.testing.assert_array_equal(np.asarray(server.drain()["a"]),
                                      _oracle(TABLES["a"], stream))
        peaks.append((server.stats.batches, server.stats.in_flight_peak))
    assert peaks[0] == peaks[1] and peaks[1][1] == 2


@pytest.mark.parametrize("policy", ["global", "per-shard"])
def test_submit_validates_ids_before_enqueue(policy):
    """Malformed queries are rejected at the door: no buffer entry, no
    scheduler entry, no sequence id consumed."""
    srv = _port(**_kw(2, batch_size=64, flush_policy=policy))
    good = zipf_queries(ROWS["a"], 5, 5.0, seed=57)
    for q in good:
        srv.submit("a", q)
    for bad in ([ROWS["a"]], [ROWS["a"] + 5], [-1], [0, ROWS["a"] + 2]):
        with pytest.raises(IndexError, match="out of range"):
            srv.submit("a", bad)
    with pytest.raises(KeyError):
        srv.submit("zzz", [1])
    if srv.scheduler is not None:
        assert srv.scheduler.pending_total() == len(good)
        assert srv.next_seq("a") == len(good), "rejected query consumed a seq"
    else:
        assert srv._buffered == len(good)
    np.testing.assert_array_equal(srv.flush()["a"].numpy(), _oracle(TABLES["a"], good))


def test_drain_producer_raises_under_global():
    srv = _port(**_kw(1))
    with pytest.raises(ValueError, match="async flush policy"):
        srv.drain(producer="p0")
    assert srv.drain() == {}


# ------------------------------------------- failure handling vs reference --


def _patched_pair(retry_port, retry_ref, make_stub, **kw):
    """The JAX and torch servers with ``_compile_and_dispatch`` wrapped by
    the same failure stub (``make_stub(orig) -> replacement``)."""
    ref = JaxServer(TABLES, HISTORIES, mesh=None, retry=retry_ref, **kw)
    port = _port(retry=retry_port, **kw)
    for srv in (ref, port):
        srv._compile_and_dispatch = make_stub(srv._compile_and_dispatch)
    return ref, port


def _ledger(srv):
    s = srv.stats.summary()["faults"]
    return {k: s[k] for k in LEDGER_FIELDS}


def test_failed_async_flush_requeues_batch_legacy():
    """Legacy policy: a dispatch failure requeues the whole batch and
    re-raises; a later drain serves every row in submission order."""
    def flaky(orig):
        calls = {"n": 0}

        def stub(entries, participants):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient device error")
            return orig(entries, participants)
        return stub

    ref, port = _patched_pair(RetryPolicy.legacy(), JaxRetry.legacy(), flaky,
                              **_kw(1, flush_policy="per-shard"))
    good = zipf_queries(ROWS["a"], 7, 5.0, seed=42)
    last = zipf_queries(ROWS["a"], 1, 5.0, seed=43)[0]
    outs = []
    for srv in (ref, port):
        for q in good:
            srv.submit("a", q)
        with pytest.raises(IndexError):
            srv.submit("a", [ROWS["a"] + 5])
        with pytest.raises(RuntimeError, match="transient"):
            srv.submit("a", last)  # trips batch_size → flush → fails
        assert srv.scheduler.pending_total() == 8, "failed flush dropped queries"
        assert srv.scheduler.requeues == 1
        outs.append(np.asarray(srv.drain()["a"]))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], _oracle(TABLES["a"], good + [last]))
    assert _ledger(port) == _ledger(ref)


def test_transient_failure_heals_by_retry():
    """Default policy: two failed attempts retry in place with seeded
    backoff; the batch dispatches on the third and nothing surfaces."""
    def twice(orig):
        calls = {"n": 0}

        def stub(entries, participants):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("transient device error")
            return orig(entries, participants)
        return stub

    ref, port = _patched_pair(RetryPolicy(seed=3), JaxRetry(seed=3), twice,
                              **_kw(2, flush_policy="owner-set"))
    for srv in (ref, port):
        for name, q in REPLAY:
            srv.submit(name, q)
    got, want = port.drain(), ref.drain()
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
        np.testing.assert_array_equal(got[n].numpy(), _oracle(TABLES[n], STREAMS[n]))
    assert _ledger(port) == _ledger(ref)
    assert _ledger(port)["retries"] == 2 and _ledger(port)["recoveries"] == 1


def test_poisoned_query_bisects_to_quarantine():
    """A batch holding one poisoned query keeps failing; bisection
    isolates exactly that query, quarantines it and serves the rest."""
    poison = ("a", 5)

    def poisoned(orig):
        def stub(entries, participants):
            if any((t, s // SEQ_STRIDE) == poison for t, s, _ in entries):
                raise RuntimeError("poisoned batch")
            return orig(entries, participants)
        return stub

    kw = _kw(1, flush_policy="per-shard")
    ref, port = _patched_pair(RetryPolicy(max_retries=1), JaxRetry(max_retries=1),
                              poisoned, **kw)
    stream = zipf_queries(ROWS["a"], 12, 5.0, seed=44)
    for srv in (ref, port):
        for q in stream:
            srv.submit("a", q)
    got, want = port.drain()["a"].numpy(), np.asarray(ref.drain()["a"])
    np.testing.assert_array_equal(got, want)
    kept = [q for i, q in enumerate(stream) if i != poison[1]]
    np.testing.assert_array_equal(got, _oracle(TABLES["a"], kept))
    assert port.stats.ledger.quarantined_keys() == ref.stats.ledger.quarantined_keys() == [poison]
    assert _ledger(port) == _ledger(ref)
    assert port.scheduler.quarantined == ref.scheduler.quarantined == 1


def test_seq_reset_guarded_by_requeued_entries():
    """drain() restarts sequence ids only when nothing requeued still
    carries the old ones."""
    srv = _port(**_kw(1, flush_policy="per-shard"), retry=RetryPolicy.legacy())
    good = zipf_queries(ROWS["a"], 7, 5.0, seed=60)
    for q in good:
        srv.submit("a", q)
    orig = srv._compile_and_dispatch

    def broken(entries, participants):
        raise RuntimeError("persistent device error")

    srv._compile_and_dispatch = broken
    last = zipf_queries(ROWS["a"], 1, 5.0, seed=61)[0]
    with pytest.raises(RuntimeError):
        srv.submit("a", last)
    assert srv.scheduler.pending_total() == 8 and srv.next_seq("a") == 8
    orig_barrier = srv._barrier
    srv._barrier = lambda: None
    assert srv.drain() == {}
    assert srv.next_seq("a") == 8, "seq reset while requeued entries alive"
    srv._barrier = orig_barrier
    srv._compile_and_dispatch = orig
    more = zipf_queries(ROWS["a"], 3, 5.0, seed=62)
    for q in more:
        srv.submit("a", q)
    np.testing.assert_array_equal(srv.drain()["a"].numpy(),
                                  _oracle(TABLES["a"], good + [last] + more))
    assert srv.next_seq("a") == 0  # clean drain: seqs restart


# ------------------------------------------------- events and the watchdog --


class _PendingEvent:
    """A CUDA event stand-in that never completes."""

    def query(self):
        return False

    def synchronize(self):
        raise AssertionError("a watchdog run must poll, never block")


def test_event_less_entry_counts_as_idle():
    """hidden_compile_s is a conservative lower bound: an entry without an
    event counts as idle (and ready), a pending event as busy."""
    srv = _port(**_kw(1, flush_policy="per-shard"))
    stub = _InFlight(outs=[torch.zeros(4, DIM)], sbq=None, served=["a"],
                     seqs={}, t0=0.0, n_queries=1)
    srv._in_flight.append(stub)
    assert srv._device_busy() is False and srv._entry_ready(stub)
    srv._in_flight.append(_InFlight(outs=[], sbq=None, served=["a"], seqs={},
                                    t0=0.0, n_queries=1, event=_PendingEvent()))
    assert srv._device_busy() is True
    srv._in_flight.clear()


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
def test_watchdog_degrades_a_hung_flush(threaded):
    """A flush whose event never completes times out under the watchdog
    and is served by the host gather+sum: rows bit-identical to the
    oracle, every flush recorded as timed out and degraded."""
    srv = _port(**_kw(2, flush_policy="owner-set", threaded=threaded),
                retry=RetryPolicy(watchdog_s=0.02, watchdog_poll_s=0.001))
    orig = srv._compile_and_dispatch

    def hung(entries, participants):
        entry = orig(entries, participants)
        entry.event = _PendingEvent()
        return entry

    srv._compile_and_dispatch = hung
    for name, q in REPLAY:
        srv.submit(name, q)
    out = srv.drain()
    srv.close()
    for n in STREAMS:
        assert out[n].dtype == torch.float32
        np.testing.assert_array_equal(out[n].numpy(), _oracle(TABLES[n], STREAMS[n]))
    led = srv.stats.ledger
    assert led.timed_out_flushes == led.degraded_flushes == srv.stats.batches >= 2
    assert srv.stats.queries == len(REPLAY)


def test_degraded_bf16_rows_keep_the_table_dtype():
    """The degrade path sums the widened host copy and casts back: on
    integer-valued tables the rows equal the oracle in bf16."""
    tables = {n: t.to(torch.bfloat16) for n, t in tables_from_numpy(TABLES, "cpu").items()}
    srv = TorchServer(tables, HISTORIES, device="cpu",
                      retry=RetryPolicy(watchdog_s=0.01, watchdog_poll_s=0.001),
                      **_kw(1, flush_policy="per-shard"))
    orig = srv._compile_and_dispatch

    def hung(entries, participants):
        entry = orig(entries, participants)
        entry.event = _PendingEvent()
        return entry

    srv._compile_and_dispatch = hung
    stream = zipf_queries(ROWS["a"], 6, 5.0, seed=70)
    for q in stream:
        srv.submit("a", q)
    out = srv.drain()["a"]
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(), _oracle(TABLES["a"], stream))
    assert srv.stats.ledger.degraded_flushes == 1


def test_host_copies_kept_only_for_the_cpu_degrade_path():
    """Only an async CPU server keeps host copies of the tables (its
    watchdog degrades to them); a global server frees them, as every
    CUDA server does."""
    assert _port(**_kw(1))._host_tables is None
    kept = _port(**_kw(1, flush_policy="per-shard"))._host_tables
    assert sorted(kept) == sorted(TABLES)
    for n in TABLES:
        np.testing.assert_array_equal(kept[n], TABLES[n])


def test_watchdog_without_host_copies_requeues_and_raises():
    """A server without host copies (every CUDA server) does not serve a
    timed-out flush on the host: its batch goes back to its home, the
    timeout raises, and the next drain serves every row from the image."""
    srv = _port(**_kw(1, flush_policy="per-shard"),
                retry=RetryPolicy(watchdog_s=0.02, watchdog_poll_s=0.001))
    srv._host_tables = None
    orig = srv._compile_and_dispatch

    def hung(entries, participants):
        entry = orig(entries, participants)
        entry.event = _PendingEvent()
        return entry

    srv._compile_and_dispatch = hung
    stream = zipf_queries(ROWS["a"], 6, 5.0, seed=71)
    for q in stream:
        srv.submit("a", q)
    with pytest.raises(FlushTimeout):
        srv.drain()
    led = srv.stats.ledger
    assert led.timed_out_flushes == 1 and led.degraded_flushes == 0
    assert srv.scheduler.pending_total() == len(stream) and not srv._in_flight
    srv._compile_and_dispatch = orig
    np.testing.assert_array_equal(srv.drain()["a"].numpy(), _oracle(TABLES["a"], stream))
    srv.close()


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
def test_kernel_error_raises_instead_of_quarantine(threaded):
    """A kernel that cannot be built or launched is not the batch's fault:
    the default policy neither retries nor quarantines it, the batch is
    requeued and the error reaches the caller."""
    srv = _port(**_kw(1, flush_policy="per-shard", threaded=threaded))
    orig = srv._compile_and_dispatch

    def broken(entries, participants):
        raise KernelError("nvcc failed (1) building crossbar_reduce.cu")

    srv._compile_and_dispatch = broken
    stream = zipf_queries(ROWS["a"], 6, 5.0, seed=72)
    for q in stream:
        srv.submit("a", q)
    with pytest.raises(KernelError, match="nvcc failed"):
        srv.drain()
    led = srv.stats.ledger
    assert led.quarantined == [] and led.retries == 0 and led.bisections == 0
    assert srv.scheduler.pending_total() == len(stream)
    srv._compile_and_dispatch = orig
    np.testing.assert_array_equal(srv.drain()["a"].numpy(), _oracle(TABLES["a"], stream))
    srv.close()


# ------------------------------------------------------------ thread driver --


def test_thread_driver_submit_is_enqueue_only():
    """submit() never dispatches inline under the driver: results arrive
    at drain() and every submit is sampled."""
    srv = _port(**_kw(2, batch_size=4, flush_policy="per-shard", threaded=True,
                      max_in_flight=1))
    stream = zipf_queries(ROWS["a"], 23, 5.0, seed=69)
    for q in stream:
        assert srv.submit("a", q) == {}
    out = srv.drain()
    srv.close()
    np.testing.assert_array_equal(out["a"].numpy(), _oracle(TABLES["a"], stream))
    assert len(srv.stats.submit_wall) == len(stream)
    assert len(srv.stats.flush_wall) == srv.stats.batches
    assert len(srv.stats.e2e_wall) == len(stream)
    lat = srv.stats.summary()["submit_latency_s"]
    assert lat["p50"] <= lat["p95"] <= lat["p99"]
    rep = srv.report()["scheduler"]
    assert rep["threaded"] is True and rep["closed"] is True
    assert srv.drain() == {}


def test_thread_driver_surfaces_failures_and_retries():
    """Legacy policy on the driver: a flush failure requeues its batch
    and surfaces at the next drain(); the drain's barrier already retried
    the batch, so the next drain returns every row in order."""
    srv = _port(**_kw(1, flush_policy="per-shard", threaded=True),
                retry=RetryPolicy.legacy())
    calls = {"n": 0}
    orig = srv._compile_and_dispatch

    def flaky(entries, participants):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device error")
        return orig(entries, participants)

    srv._compile_and_dispatch = flaky
    stream = zipf_queries(ROWS["a"], 9, 5.0, seed=72)
    for q in stream[:8]:
        srv.submit("a", q)  # the 8th trips the flush on the driver → fails
    with pytest.raises(RuntimeError, match="transient device error"):
        srv.drain()
    out = srv.drain()
    for q in stream[8:]:
        srv.submit("a", q)
    out2 = srv.drain()
    srv.close()
    got = np.concatenate([out["a"].numpy(), out2["a"].numpy()])
    np.testing.assert_array_equal(got, _oracle(TABLES["a"], stream))
    assert srv.scheduler.requeues == 1


def test_close_preserves_handoff_backlog():
    """close() pushes the driver's unpopped hand-off items back into the
    scheduler; a later (inline) drain serves every row in order."""
    srv = _port(**_kw(2, batch_size=64, flush_policy="per-shard", threaded=True))
    stream = zipf_queries(ROWS["a"], 9, 5.0, seed=77)
    for q in stream:
        srv.submit("a", q)
    srv.close()
    assert srv._driver is None and srv._handoff is None
    lost = srv.stats.ledger.lost_work
    assert lost["requeued"] == len(stream) and lost["driver_leaked"] == 0
    np.testing.assert_array_equal(srv.drain()["a"].numpy(), _oracle(TABLES["a"], stream))
    with pytest.raises(RuntimeError, match="closed server"):
        srv.submit("a", stream[0])


# ------------------------------------------------------ policy and schema --


def test_retry_policy_matches_reference():
    """backoff_s draws the same seeded jitter; parse/legacy/validation
    behave as the reference's."""
    for seed in (0, 7):
        port, ref = RetryPolicy(seed=seed), JaxRetry(seed=seed)
        rng_p, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
        got = [port.backoff_s(a, rng_p) for a in range(8)]
        want = [ref.backoff_s(a, rng_r) for a in range(8)]
        assert got == want
    assert vars(RetryPolicy.legacy()) == vars(JaxRetry.legacy())
    assert vars(RetryPolicy.parse(None)) == vars(JaxRetry.parse(None))
    with pytest.raises(TypeError):
        RetryPolicy.parse("fast")
    for bad in ({"max_retries": -1}, {"jitter": 1.0}, {"watchdog_s": 0.0}):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)


def test_error_ledger_and_percentiles_match_reference():
    port, ref = ErrorLedger(), JaxLedger()
    for led in (port, ref):
        led.quarantine("a", 3, RuntimeError("x"))
        led.quarantine("b", 1, RuntimeError("y"), producer="p1")
        led.record_recovery(0.5)
        led.retries += 2
    assert port.summary() == ref.summary()
    assert port.quarantined_keys() == ref.quarantined_keys()
    assert port.quarantined_keys_by_producer() == ref.quarantined_keys_by_producer()
    for samples in ([], [1.0, 2.0, 3.0, 4.0], [0.25]):
        assert latency_percentiles(samples) == jax_percentiles(samples)
    assert latency_percentiles([1.0, 2.0, 3.0, 4.0])["p50"] == 2.5
    assert issubclass(FlushTimeout, RuntimeError)


def test_report_schema_matches_reference():
    """report()["serve"] and report()["scheduler"] carry the reference's
    keys; the port adds only ``device`` and ``image_bytes``."""
    kw = _kw(2, flush_policy="owner-set")
    ref = JaxServer(TABLES, HISTORIES, mesh=None, **kw)
    port = _port(**kw)
    for srv in (ref, port):
        for name, q in REPLAY[:10]:
            srv.submit(name, q, producer="p0")
        srv.drain()
        srv.close()
    rr, rp = ref.report(), port.report()
    assert set(rp) - set(rr) == {"device", "image_bytes"}
    assert set(rr) - set(rp) == set()
    assert set(rp["serve"]) == set(rr["serve"])
    assert set(rp["serve"]["tiers"]) == set(rr["serve"]["tiers"])
    assert set(rp["serve"]["faults"]) == set(rr["serve"]["faults"])
    assert rp["scheduler"] == rr["scheduler"]
    assert rp["retry"] == rr["retry"]
