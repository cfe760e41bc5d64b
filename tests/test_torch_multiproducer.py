"""The port's multi-producer front door (DESIGN.md §10): ``repro_torch.
serve``'s ``ProducerRegistry`` and ``ShardedEmbeddingServer(producer=...)``
on the CPU against ``repro.serve``'s.

Mirrors ``tests/test_multiproducer.py``.  Concurrent producers may
interleave in any order, so every assertion is on what submission alone
decides: a full drain merges streams in ``(local_seq, producer_id)``
order, a per-producer drain returns that producer's FIFO.  On
integer-valued tables those rows must be bit-identical to the reference
server's drain of the same submissions and to a host gather+sum.  Every
join has a timeout; no sleep stands in for synchronisation.
"""

import sys
import threading
import time

import numpy as np
import pytest

from repro.data import zipf_queries
from repro.serve import ProducerRegistry as JaxRegistry
from repro.serve import ShardedEmbeddingServer as JaxServer
from repro_torch.convert import tables_from_numpy
from repro_torch.kernels._build import locked_cache
from repro_torch.serve import (
    DEFAULT_PRODUCER,
    SEQ_STRIDE,
    ProducerRegistry,
    ShardedEmbeddingServer as TorchServer,
)
from repro_torch.serve.producers import local_seq_of, producer_of

ROWS, DIM = 160, 128
TABLE_CYCLE = ("a", "b")
JOIN_S = 120


def _int_table(seed):
    """Integer-valued f32 table: partial sums are exact in float32."""
    return np.random.default_rng(seed).integers(-8, 9, size=(ROWS, DIM)).astype(np.float32)


TABLES = {"a": _int_table(11), "b": _int_table(12)}
HISTORIES = {"a": zipf_queries(ROWS, 48, 5.0, seed=13),
             "b": zipf_queries(ROWS, 48, 5.0, seed=14)}


def _kw(num_shards=2, batch_size=8, policy="per-shard", **kw):
    return {"num_shards": num_shards, "q_block": 4, "group_size": 16,
            "batch_size": batch_size, "flush_policy": policy, **kw}


def _server(**kw):
    return TorchServer(tables_from_numpy(TABLES, "cpu"), HISTORIES, device="cpu", **_kw(**kw))


def _streams(n_producers, n_submits, seed0=100):
    """One query stream per producer (tables alternate per submit)."""
    return [
        list(zipf_queries(ROWS, n_submits, 5.0, seed=seed0 + p,
                          num_baskets=max(16, n_submits // 4)))
        for p in range(n_producers)
    ]


def _oracle(table, queries):
    return np.stack([table[np.unique(np.asarray(q, np.int64))].sum(axis=0) for q in queries])


def _producer_oracle(stream):
    """Expected per-table FIFO rows of ONE producer's stream."""
    per = {n: [] for n in TABLE_CYCLE}
    for i, q in enumerate(stream):
        per[TABLE_CYCLE[i % 2]].append(q)
    return {n: _oracle(TABLES[n], qs) for n, qs in per.items() if qs}


def _join(threads):
    for t in threads:
        t.join(timeout=JOIN_S)
        assert not t.is_alive(), "producer thread wedged"


def _submit_concurrently(srv, streams, labels):
    """Submits every stream from its own thread; returns the exceptions."""
    errs = []

    def body(idx):
        try:
            for i, q in enumerate(streams[idx]):
                srv.submit(TABLE_CYCLE[i % 2], q, producer=labels[idx])
        except Exception as e:  # surfaced to the test below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(len(streams))]
    for t in threads:
        t.start()
    _join(threads)
    return errs


# ------------------------------------------------------------- registry --


def test_producer_registry_matches_reference():
    """Stamps, decode, next_seq, reset and state equal the reference's."""
    port, ref = ProducerRegistry(), JaxRegistry()
    for reg in (port, ref):
        assert reg.register("p1") == 0 and reg.register(None) == 1
    script = [("p1", "a"), (None, "a"), ("p1", "a"), ("p2", "b"), (None, "b"), ("p1", "b")]
    got = [port.stamp(p, t) for p, t in script]
    assert got == [ref.stamp(p, t) for p, t in script]
    assert got[:3] == [0, 1, SEQ_STRIDE]
    for g in got:
        assert port.decode(g) == ref.decode(g)
        assert producer_of(g) == g % SEQ_STRIDE and local_seq_of(g) == g // SEQ_STRIDE
    assert port.decode(7 * SEQ_STRIDE + 99) == (DEFAULT_PRODUCER, 7)
    assert port.producers() == ref.producers() == ["p1", DEFAULT_PRODUCER, "p2"]
    assert port.next_seq("a", "p1") == ref.next_seq("a", "p1") == 2
    assert port.pid("nobody") is None and port.next_seq("a", "nobody") == 0
    assert port.state() == ref.state()
    port.reset_seqs()
    ref.reset_seqs()
    assert port.state() == ref.state() and port.next_seq("a", "p1") == 0
    assert port.producers() == ["p1", DEFAULT_PRODUCER, "p2"]


def test_producer_registry_capacity_guards():
    """At a small stride the pid space runs out with the reference's
    error, and a local seq that would overflow the packed int64 raises."""
    for cls in (ProducerRegistry, JaxRegistry):
        reg = cls(stride=4)
        for p in range(4):
            assert reg.register(f"p{p}") == p
        with pytest.raises(RuntimeError, match="producer capacity exhausted"):
            reg.register("p4")
        big = cls(stride=1 << 62)
        big.stamp("p0", "a")
        with pytest.raises(OverflowError, match="sequence capacity exhausted"):
            big.stamp("p0", "a")


# ---------------------------------------------------------------- drains --


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_merged_drain_bit_identical_to_reference(num_shards, threaded):
    """Three producers submit concurrently; the full drain is the
    ``(local_seq, producer_id)`` interleave, bit-identical to the JAX
    server's drain of the same submissions and to a single-producer
    replay in merge order."""
    n_prod, n_sub = 3, 24
    streams = _streams(n_prod, n_sub, seed0=200)
    labels = [f"p{p}" for p in range(n_prod)]
    srv = _server(num_shards=num_shards, threaded=threaded)
    for lab in labels:
        srv.register_producer(lab)
    assert not _submit_concurrently(srv, streams, labels)
    got = {n: o.numpy() for n, o in srv.drain().items()}
    srv.close()

    ref = JaxServer(TABLES, HISTORIES, mesh=None, **_kw(num_shards=num_shards))
    for lab in labels:
        ref.register_producer(lab)
    for p, lab in enumerate(labels):  # any submission order merges the same
        for i, q in enumerate(streams[p]):
            ref.submit(TABLE_CYCLE[i % 2], q, producer=lab)
    want = {n: np.asarray(o) for n, o in ref.drain().items()}
    assert sorted(got) == sorted(want) == list(TABLE_CYCLE)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n])
    # merge order: position-major, producer-minor
    merged = {n: [] for n in TABLE_CYCLE}
    for i in range(n_sub):
        for p in range(n_prod):
            merged[TABLE_CYCLE[i % 2]].append(streams[p][i])
    for n in TABLE_CYCLE:
        np.testing.assert_array_equal(got[n], _oracle(TABLES[n], merged[n]))
    assert srv.next_seq("a", "p0") == 0  # quiesced full drain reset the spaces


@pytest.mark.parametrize("threaded", [False, True], ids=["inline", "threaded"])
def test_per_producer_drains_match_reference(threaded):
    """drain(producer=...) hands back that producer's FIFO alone, equal to
    the reference's; other streams stay stashed for their own drains."""
    n_prod, n_sub = 3, 20
    streams = _streams(n_prod, n_sub, seed0=250)
    labels = [f"p{p}" for p in range(n_prod)]
    srv = _server(num_shards=4, policy="owner-set", threaded=threaded)
    ref = JaxServer(TABLES, HISTORIES, mesh=None, **_kw(num_shards=4, policy="owner-set"))
    for server in (srv, ref):
        for lab in labels:
            server.register_producer(lab)
    assert not _submit_concurrently(srv, streams, labels)
    for p, lab in enumerate(labels):
        for i, q in enumerate(streams[p]):
            ref.submit(TABLE_CYCLE[i % 2], q, producer=lab)
    for p in (2, 0, 1):
        got, want = srv.drain(producer=labels[p]), ref.drain(producer=labels[p])
        assert sorted(got) == sorted(want)
        for n, rows in _producer_oracle(streams[p]).items():
            np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
            np.testing.assert_array_equal(got[n].numpy(), rows)
        # per-producer drains never reset the sequence spaces
        assert srv.next_seq("a", labels[p]) == n_sub // 2
    assert srv.drain(producer="never-registered") == {}
    assert srv.drain() == {}
    srv.close()
    assert srv.stats.summary()["queries"] == n_prod * n_sub
    assert srv.scheduler.pushed_by_producer == {lab: n_sub for lab in labels}


def test_multiproducer_stress_fifo_deterministic():
    """8 producers on the thread driver: every producer's drain returns
    exactly its own stream in its own order, whatever the interleave."""
    n_prod, n_sub = 8, 512
    streams = _streams(n_prod, n_sub)
    srv = _server(num_shards=4, batch_size=16, threaded=True)
    labels = [f"p{i}" for i in range(n_prod)]
    for lab in labels:
        srv.register_producer(lab)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        assert not _submit_concurrently(srv, streams, labels)
    finally:
        sys.setswitchinterval(interval)
    for lab, stream in zip(labels, streams):
        out = srv.drain(producer=lab)
        want = _producer_oracle(stream)
        assert set(out) == set(want)
        for n in want:
            np.testing.assert_array_equal(out[n].numpy(), want[n])
    assert srv.drain() == {}
    assert all(srv.scheduler.pushed_by_producer[lab] == n_sub for lab in labels)
    srv.close()


# ------------------------------------------------------- lifecycle races --


def test_drain_seq_reset_race_with_concurrent_submits():
    """Full drains racing a live submitter never reset the sequence
    spaces while a stamp is in flight: the concatenated drains equal the
    FIFO oracle bit for bit."""
    stream = list(zipf_queries(ROWS, 150, 5.0, seed=400, num_baskets=32))
    srv = _server(num_shards=2, batch_size=4, threaded=True)
    done = threading.Event()
    errs = []

    def body():
        try:
            for q in stream:
                srv.submit("a", q)
        except Exception as e:  # surfaced to the test below
            errs.append(e)
        finally:
            done.set()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    chunks = []
    t = threading.Thread(target=body, daemon=True)
    try:
        t.start()
        while not done.is_set():
            out = srv.drain()
            if "a" in out:
                chunks.append(out["a"].numpy())
        _join([t])
    finally:
        sys.setswitchinterval(interval)
    assert not errs, errs
    out = srv.drain()
    if "a" in out:
        chunks.append(out["a"].numpy())
    srv.close()
    np.testing.assert_array_equal(np.concatenate(chunks), _oracle(TABLES["a"], stream))
    assert srv.next_seq("a") == 0


def test_close_racing_concurrent_submits():
    """close() against 4 live submitters: late submits get the clean
    RuntimeError, accepted work is recorded in ``ledger.lost_work`` and
    served by a later inline drain, and a second close is a no-op."""
    n_prod, n_sub = 4, 60
    streams = _streams(n_prod, n_sub, seed0=500)
    # batch far above the traffic: everything stays pending
    srv = _server(num_shards=2, batch_size=256, threaded=True)
    labels = [f"p{i}" for i in range(n_prod)]
    for lab in labels:
        srv.register_producer(lab)
    accepted = [0] * n_prod
    rejected = [0] * n_prod
    first_accepted = threading.Barrier(n_prod + 1, timeout=JOIN_S)
    closed = threading.Event()
    errs = []

    def submit(idx, i, q):
        try:
            srv.submit(TABLE_CYCLE[i % 2], q, producer=labels[idx])
            accepted[idx] += 1
        except RuntimeError as e:
            assert "closed server" in str(e)
            rejected[idx] += 1

    def body(idx):
        try:
            submit(idx, 0, streams[idx][0])
            first_accepted.wait()
            for i, q in enumerate(streams[idx][1:], start=1):
                submit(idx, i, q)  # races close()
            assert closed.wait(JOIN_S)
            submit(idx, n_sub, streams[idx][0])  # after close: rejected
        except Exception as e:  # surfaced to the test below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(i,), daemon=True) for i in range(n_prod)]
    for t in threads:
        t.start()
    first_accepted.wait()
    srv.close()
    closed.set()
    _join(threads)
    assert not errs, errs
    assert all(a >= 1 for a in accepted) and all(r >= 1 for r in rejected)
    assert srv._driver is None and srv._handoff is None
    lost = srv.stats.ledger.lost_work
    assert lost is not None and lost["requeued"] == sum(accepted), lost
    t0 = time.perf_counter()
    srv.close()
    assert time.perf_counter() - t0 < 2.0
    served = 0
    for lab in labels:
        for o in srv.drain(producer=lab).values():
            served += o.shape[0]
    assert served == sum(accepted)


def test_wall_deadline_flushes_idle_stream():
    """A quiet stream's pending queries flush when their wall age crosses
    ``flush_deadline_s``, fired by the driver's idle loop alone."""
    stream = list(zipf_queries(ROWS, 4, 5.0, seed=600, num_baskets=8))
    srv = _server(num_shards=2, batch_size=64, threaded=True, flush_deadline_s=0.05)
    for q in stream:
        srv.submit("a", q, producer="p0")
    deadline = time.perf_counter() + 30.0
    while srv.stats.deadline_flushes < 1 and time.perf_counter() < deadline:
        time.sleep(0.01)  # polls an observed condition, bounded
    assert srv.stats.deadline_flushes >= 1, "wall deadline never fired"
    out = srv.drain(producer="p0")
    srv.close()
    np.testing.assert_array_equal(out["a"].numpy(), _oracle(TABLES["a"], stream))


# ------------------------------------------------------- kernel loaders --


def test_locked_cache_builds_once_under_concurrent_first_calls():
    """Two threads that make a first launch together run the (cached)
    loader once: a second ``nvcc`` into the same path never starts."""
    calls = []
    gate = threading.Barrier(8, timeout=JOIN_S)

    @locked_cache
    def load(name):
        calls.append(name)
        time.sleep(0.05)  # a slow build widens the race window
        return object()

    results = []

    def body():
        gate.wait()
        results.append(load("crossbar"))

    threads = [threading.Thread(target=body, daemon=True) for _ in range(8)]
    for t in threads:
        t.start()
    _join(threads)
    assert calls == ["crossbar"]
    assert len(results) == 8 and all(r is results[0] for r in results)
