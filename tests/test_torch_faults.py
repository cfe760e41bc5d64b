"""Fault injection and self-healing of the port (the injection half of
``repro_torch.serve.faults`` and its seams in ``serve.
ShardedEmbeddingServer``) on the CPU against ``repro``'s.

The same seeded fault plan fires at the same seams of both servers: the
drained rows must be bit-identical (integer-valued tables) to the
reference's and to the fault-free oracle minus exactly the poisoned
queries, with equal retries, bisections, quarantined keys and per-seam
injection counts.  A hung flush degrades to the host on a CPU server
as in the reference; on the card it is requeued and ``FlushTimeout``
raises, which a CPU server without host tables shows here.  Mirrors
``tests/test_faults.py``.
"""

import threading
import time

import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro.serve.faults as jfaults
import repro_torch.serve as tserve
import repro_torch.serve.faults as tfaults
from repro.data import zipf_queries
from repro_torch.convert import tables_from_numpy

ROWS, DIM = 160, 128
#: fast-backoff policy so healing tests don't sleep for real
FAST = dict(backoff_base=1e-4, backoff_max=1e-3)
LEDGER = ("retries", "bisections", "degraded_flushes", "timed_out_flushes",
          "patch_failures", "patches_dropped")
PACKAGES = {"ref": (jserve, jfaults), "port": (tserve, tfaults)}


def _int_table(seed):
    """Integer-valued f32 table: partial sums are exact in float32."""
    return np.random.default_rng(seed).integers(-8, 9, size=(ROWS, DIM)).astype(np.float32)


TABLES = {"a": _int_table(11), "b": _int_table(12)}
HISTORIES = {"a": zipf_queries(ROWS, 48, 5.0, seed=13),
             "b": zipf_queries(ROWS, 48, 5.0, seed=14)}
STREAMS = {"a": zipf_queries(ROWS, 20, 5.0, seed=15),
           "b": zipf_queries(ROWS, 12, 5.0, seed=16)}
REPLAY = [("a", q) for q in STREAMS["a"]] + [("b", q) for q in STREAMS["b"]]
ORACLE = {n: np.stack([TABLES[n][np.unique(q)].sum(axis=0) for q in STREAMS[n]])
          for n in TABLES}


def _plan(pkg, specs, seed=0):
    plan = PACKAGES[pkg][1].FaultPlan([], seed=seed)
    for kind, kw in specs:
        plan.add(kind, **kw)
    return plan


def _server(pkg, specs=(), *, retry=None, card=False, **kw):
    serve, faults = PACKAGES[pkg]
    kw = {"num_shards": 2, "q_block": 4, "group_size": 16, "batch_size": 4,
          "flush_policy": "per-shard", **kw}
    if pkg == "port":
        tables, kw["device"] = tables_from_numpy(TABLES, "cpu"), "cpu"
    else:
        tables = TABLES
    srv = serve.ShardedEmbeddingServer(
        tables, HISTORIES, retry=faults.RetryPolicy(**(retry or {})),
        faults=_plan(pkg, specs) if specs else None, **kw,
    )
    if card:
        # a server without host tables takes the card's branch: a hung
        # flush is requeued and FlushTimeout raises
        srv._host_tables = None
    return srv


def _replay(srv, replay=REPLAY):
    """Submits the replay and drains; a FlushTimeout (the card's hang
    branch) surfacing at a submit or a drain is counted.  A drain is
    repeated; so is a threaded submit, which raises a stashed driver
    error before it takes the query, while an inline submit raises from
    the flush it ran after taking it.  Returns ``(rows, timeouts)``;
    closes the server."""
    timeouts = 0
    for name, q in replay:
        while True:
            try:
                srv.submit(name, q)
                break
            except (jfaults.FlushTimeout, tfaults.FlushTimeout):
                timeouts += 1
                if not srv.policy.threaded:
                    break
    while True:
        try:
            out = srv.drain()
            break
        except (jfaults.FlushTimeout, tfaults.FlushTimeout):
            timeouts += 1
    srv.close()
    return {n: _rows(out[n]) for n in out}, timeouts


def _rows(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _ledger(srv):
    led = srv.stats.ledger
    return {k: getattr(led, k) for k in LEDGER} | {"quarantined": led.quarantined_keys()}


def _both(specs=(), **kw):
    """The replay through the reference's and the port's servers."""
    ref, port = _server("ref", specs, **kw), _server("port", specs, **kw)
    ref_out, _ = _replay(ref)
    port_out, timeouts = _replay(port)
    assert timeouts == 0
    assert set(ref_out) == set(port_out)
    for n in ref_out:
        np.testing.assert_array_equal(port_out[n], ref_out[n])
    assert _ledger(port) == _ledger(ref)
    if specs:
        assert port.report()["faults"] == ref.report()["faults"]
    return ref, port, port_out


def _without(keys):
    """The oracle minus the quarantined ``(table, seq)`` keys."""
    return {n: ORACLE[n][[i for i in range(len(STREAMS[n])) if (n, i) not in keys]]
            for n in ORACLE}


# ------------------------------------------------- plan / policy units --


def test_fault_spec_validation_matches_reference():
    for pkg in PACKAGES:
        faults = PACKAGES[pkg][1]
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.FaultSpec("meteor")
        with pytest.raises(ValueError, match="table= and seq="):
            faults.FaultSpec("poison")
        with pytest.raises(ValueError, match="times"):
            faults.FaultSpec("compile", times=0)
        with pytest.raises(ValueError, match="unknown fault kind"):
            faults.FaultPlan.random(0, {"meteor": 1})
        with pytest.raises(ValueError, match="tables="):
            faults.FaultPlan.random(0, {"poison": 1})
        with pytest.raises(TypeError):
            faults.FaultInjector.parse("chaos")
    assert tfaults.KINDS == jfaults.KINDS


def _spec_tuple(s):
    return (s.kind, s.tick, s.times, s.table, s.seq, s.producer, s.hang_s)


@pytest.mark.parametrize("seed", [0, 5, 6, 123])
@pytest.mark.parametrize("producers", [(), ("p0", "p1", "p2")])
def test_fault_plan_random_draws_the_reference_plan(seed, producers):
    counts = {"compile": 2, "device": 1, "device-late": 1, "poison": 2, "hang": 1,
              "patch": 1}
    kw = dict(horizon=8, tables=("a", "b"), max_seq=20, hang_s=9.0, times=2,
              producers=producers)
    port = tfaults.FaultPlan.random(seed, counts, **kw)
    ref = jfaults.FaultPlan.random(seed, counts, **kw)
    assert [_spec_tuple(s) for s in port.specs] == [_spec_tuple(s) for s in ref.specs]
    assert port.poisoned() == ref.poisoned()
    assert port.poisoned_by_producer() == ref.poisoned_by_producer()
    assert port.summary() == ref.summary()
    assert port.summary()["faults"] == counts
    assert [_spec_tuple(s) for s in tfaults.FaultPlan.random(seed, counts, **kw).specs] \
        == [_spec_tuple(s) for s in port.specs]


def test_injector_attempt_windows_match_reference():
    """tick=t, times=k fails attempts t..t+k-1 at that seam only; the
    poison fires at every attempt; the counters advance alike."""
    specs = [("compile", {"tick": 1, "times": 2}), ("device", {"tick": 0}),
             ("hang", {"tick": 1, "hang_s": 0.5}), ("hang", {"tick": 2}),
             ("device-late", {"tick": 2}), ("patch", {"tick": 1}),
             ("poison", {"table": "a", "seq": 3})]
    seams = []
    for pkg in PACKAGES:
        inj = PACKAGES[pkg][1].FaultInjector(_plan(pkg, specs))
        log = []
        for _ in range(4):
            for call in (lambda: inj.on_compile([("a", 4, [2])]),
                         lambda: inj.on_compile([("a", 3, [1]), ("a", 4, [2])]),
                         inj.on_dispatch, inj.on_retire, inj.on_patch):
                try:
                    log.append(call())
                except Exception as e:
                    log.append(type(e).__name__)
        seams.append((log, inj.summary()))
    assert seams[0] == seams[1]
    assert "PoisonedQueryError" in seams[0][0] and 0.5 in seams[0][0]


def test_retry_policy_and_ledger_match_reference():
    for kw in ({}, {"max_retries": 0, "bisect": False, "quarantine": False},
               {"backoff_base": 0.01, "jitter": 0.25, "seed": 3}):
        port, ref = tfaults.RetryPolicy(**kw), jfaults.RetryPolicy(**kw)
        pr, rr = np.random.default_rng(1), np.random.default_rng(1)
        assert [port.backoff_s(a, pr) for a in range(5)] == \
            [ref.backoff_s(a, rr) for a in range(5)]
    assert tfaults.RetryPolicy.legacy() == tfaults.RetryPolicy(
        max_retries=0, bisect=False, quarantine=False)


# --------------------------------------- legacy driver fault branches --


def _submit_all(srv, replay):
    """Submits ``replay``; returns whether a submit raised the injected
    fault.  An inline submit raises from the flush it ran after taking
    its query.  A threaded submit raises a fault the driver stashed
    before it takes its query, so it is repeated until it does: when
    the driver reaches the fault before the last submit, that query
    would otherwise be lost."""
    raised = False
    for name, q in replay:
        while True:
            try:
                srv.submit(name, q)
                break
            except tfaults.InjectedFault:
                raised = True
                if not srv.policy.threaded:
                    break
    return raised


@pytest.mark.parametrize("num_shards", [1, 2, 4])
@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("kind", ["compile", "device"])
def test_legacy_requeue_and_reraise_branches(num_shards, threaded, kind):
    """Under ``RetryPolicy.legacy()`` a dispatch-time fault requeues the
    batch and the error surfaces (inline: at a submit; threaded: at a
    drain); a later drain serves every row, in order, as the oracle."""
    srv = _server("port", [(kind, {"tick": 0})], num_shards=num_shards,
                  threaded=threaded, retry={"max_retries": 0, "bisect": False,
                                            "quarantine": False})
    raised = _submit_all(srv, REPLAY)
    if threaded:
        deadline = time.monotonic() + 30.0
        while not raised and time.monotonic() < deadline:
            try:
                srv.drain()
            except tfaults.InjectedFault:
                raised = True
    assert raised, "legacy must re-raise the injected fault"
    assert srv.scheduler.requeues >= 1
    out = srv.drain()
    for n in TABLES:
        np.testing.assert_array_equal(_rows(out[n]), ORACLE[n])
    led = srv.stats.ledger
    assert not led.quarantined and led.retries == 0
    srv.close()


@pytest.mark.parametrize("threaded", [False, True])
def test_legacy_late_device_fault_requeues_at_retire(threaded):
    srv = _server("port", [("device-late", {"tick": 0})], threaded=threaded,
                  retry={"max_retries": 0, "bisect": False, "quarantine": False})
    raised, outs = _submit_all(srv, REPLAY), []
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        try:
            out = srv.drain()
        except tfaults.InjectedFault:
            raised = True
            continue
        outs.append(out)
        if raised and srv.scheduler.pending_total() == 0:
            break
    assert raised and srv.scheduler.requeues >= 1
    for n in TABLES:
        served = np.concatenate([_rows(o[n]) for o in outs if n in o])
        assert served.shape == ORACLE[n].shape
        np.testing.assert_array_equal(served[np.lexsort(served.T)],
                                      ORACLE[n][np.lexsort(ORACLE[n].T)])
    srv.close()


def test_threaded_submit_after_stashed_fault_takes_no_query():
    """The race the replay loops guard against, forced: the driver
    stashes a compile fault before the next submit, which raises it
    without taking its query; the retried submit takes it, and the drain
    serves every query exactly once, bit for bit as the oracle."""
    srv = _server("port", [("compile", {"tick": 0})], num_shards=1, threaded=True,
                  retry={"max_retries": 0, "bisect": False, "quarantine": False})
    due = srv.policy.batch_size     # one home: the first flush is due here
    for name, q in REPLAY[:due]:
        srv.submit(name, q)
    deadline = time.monotonic() + 30.0
    while not srv._driver_errors and time.monotonic() < deadline:
        time.sleep(0.001)
    assert srv._driver_errors, "the driver never stashed the compile fault"
    name, q = REPLAY[due]
    with pytest.raises(tfaults.InjectedFault):
        srv.submit(name, q)
    assert not srv._driver_errors
    srv.submit(name, q)
    for name, q in REPLAY[due + 1:]:
        srv.submit(name, q)
    out = srv.drain()
    assert srv.scheduler.requeues >= 1
    for n in TABLES:
        np.testing.assert_array_equal(_rows(out[n]), ORACLE[n])
    srv.close()


# ------------------------------------------- self-healing ≡ reference --


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_healing_transient_faults_match_reference(num_shards):
    specs = [("compile", {"tick": 0, "times": 2}), ("device", {"tick": 2}),
             ("device-late", {"tick": 1})]
    _ref, port, out = _both(specs, num_shards=num_shards,
                            retry={"max_retries": 3, **FAST})
    for n in TABLES:
        np.testing.assert_array_equal(out[n], ORACLE[n])
    led = port.stats.ledger
    assert led.retries >= 3 and led.backoff_s > 0 and not led.quarantined
    assert led.recovery_s
    assert port.stats.summary()["faults"]["recoveries"] == len(led.recovery_s)


@pytest.mark.parametrize("threaded", [False, True])
def test_poison_bisected_and_quarantined_like_reference(threaded):
    _ref, port, out = _both([("poison", {"table": "a", "seq": 3})], threaded=threaded,
                            retry={"max_retries": 1, **FAST})
    led = port.stats.ledger
    assert led.quarantined_keys() == [("a", 3)]
    assert "PoisonedQueryError" in led.quarantined[0][2]
    assert led.bisections >= 1 and port.scheduler.quarantined == 1
    want = _without({("a", 3)})
    for n in TABLES:
        np.testing.assert_array_equal(out[n], want[n])


def test_quarantine_without_bisection_drops_whole_batch_like_reference():
    _ref, port, out = _both([("poison", {"table": "b", "seq": 0})],
                            retry={"max_retries": 0, "bisect": False, **FAST})
    led = port.stats.ledger
    assert led.bisections == 0 and ("b", 0) in led.quarantined_keys()
    want = _without(set(led.quarantined_keys()))
    for n in TABLES:
        np.testing.assert_array_equal(out[n], want[n])


# ------------------------------------------------- watchdog / hangs --


@pytest.mark.parametrize("threaded", [False, True])
def test_watchdog_degrades_hung_flush_on_cpu_like_reference(threaded):
    _ref, port, out = _both([("hang", {"tick": 1, "hang_s": 999.0})], threaded=threaded,
                            retry={"max_retries": 1, "watchdog_s": 0.2, **FAST})
    led = port.stats.ledger
    assert led.timed_out_flushes >= 1 and led.degraded_flushes >= 1
    for n in TABLES:
        np.testing.assert_array_equal(out[n], ORACLE[n])


@pytest.mark.parametrize("threaded", [False, True])
@pytest.mark.parametrize("watchdog_s", [0.2, None])
def test_hung_flush_on_the_card_requeues_and_raises(threaded, watchdog_s):
    """The card's branch: a hung flush (past the watchdog, or an infinite
    hang with none) is requeued and ``FlushTimeout`` raises; the next
    drain serves the requeued batch, every row as the oracle."""
    srv = _server("port", [("hang", {"tick": 1, **({"hang_s": 999.0} if watchdog_s else {})})],
                  threaded=threaded, card=True,
                  retry={"max_retries": 1, "watchdog_s": watchdog_s, **FAST})
    out, timeouts = _replay(srv)
    assert timeouts >= 1
    led = srv.stats.ledger
    assert led.timed_out_flushes >= 1 and led.degraded_flushes == 0
    assert srv.scheduler.requeues >= 1
    for n in TABLES:
        np.testing.assert_array_equal(out[n], ORACLE[n])


def test_infinite_hang_without_watchdog_degrades_on_cpu_like_reference():
    _ref, port, out = _both([("hang", {"tick": 0})], retry={"max_retries": 0, **FAST})
    assert port.stats.ledger.degraded_flushes >= 1
    for n in TABLES:
        np.testing.assert_array_equal(out[n], ORACLE[n])


def test_short_hang_recovers_without_degrade():
    t0 = time.monotonic()
    _ref, port, out = _both([("hang", {"tick": 0, "hang_s": 0.05})],
                            retry={"watchdog_s": 5.0, **FAST})
    led = port.stats.ledger
    assert led.timed_out_flushes == 0 and led.degraded_flushes == 0
    assert port.stats.ledger.timed_out_flushes == 0
    assert time.monotonic() - t0 < 60.0
    for n in TABLES:
        np.testing.assert_array_equal(out[n], ORACLE[n])


# ------------------------------------------------------- patch seam --


def test_patch_fault_retries_then_drops():
    """A failing staged patch stays staged for the next barriers, then is
    dropped (recorded); the sentinel never reaches the real apply path.
    Under the legacy policy the failure re-raises."""
    srv = _server("port", [("patch", {"tick": 0, "times": 3})],
                  retry={"patch_retries": 1, **FAST})
    staged = object()
    srv._staged = staged
    srv._apply_staged_patch()
    assert srv._staged is staged
    srv._apply_staged_patch()
    assert srv._staged is None
    led = srv.stats.ledger
    assert led.patch_failures == 2 and led.patches_dropped == 1
    legacy = _server("port", [("patch", {"tick": 0})],
                     retry={"max_retries": 0, "bisect": False, "quarantine": False})
    legacy._staged = object()
    with pytest.raises(tfaults.InjectedFault):
        legacy._apply_staged_patch()


@pytest.mark.parametrize("policy", ["global", "owner-set"])
def test_patch_fault_on_a_replanning_server_matches_reference(policy):
    """Real patches through the patch seam: the first two applies fail
    and stay staged (``patch_retries`` 2), the third applies; rows,
    replans and patch failures equal the reference's."""
    perm = np.random.default_rng(24).permutation(ROWS)
    stream = zipf_queries(ROWS, 160, 5.0, seed=23)
    stream = stream[:40] + [perm[np.asarray(q)].tolist() for q in stream[40:]]
    replay = [("a", q) for q in stream]
    outs = []
    for pkg in PACKAGES:
        serve = PACKAGES[pkg][0]
        srv = _server(pkg, [("patch", {"tick": 0, "times": 2})], flush_policy=policy,
                      batch_size=8, batch_size_for_eq1=512,
                      retry={"patch_retries": 2, **FAST},
                      replan=serve.ReplanConfig(threshold=0.15, half_life=1.0,
                                                min_queries=8, slack_tiles=4))
        parts = []
        for name, q in replay:
            out = srv.submit(name, q)
            if out:
                parts.append(_rows(out["a"]))
        out = srv.flush()
        if out:
            parts.append(_rows(out["a"]))
        srv.close()
        outs.append((srv, np.concatenate(parts)))
    (ref, ref_rows), (port, port_rows) = outs
    np.testing.assert_array_equal(port_rows, ref_rows)
    want = np.stack([TABLES["a"][np.unique(q)].sum(axis=0) for q in stream])
    np.testing.assert_array_equal(port_rows, want)
    assert port.stats.ledger.patch_failures == 2
    assert port.stats.replans >= 1
    assert _ledger(port) == _ledger(ref)
    assert port.stats.replans == ref.stats.replans
    assert port.report()["faults"] == ref.report()["faults"]


# ------------------------------------------------ acceptance scenario --


CHAOS = [("compile", {"tick": 0, "times": 2}), ("device", {"tick": 2}),
         ("poison", {"table": "a", "seq": 5}), ("hang", {"tick": 4, "hang_s": 999.0})]
CHAOS_RETRY = {"max_retries": 3, "watchdog_s": 0.2, **FAST}


def test_chaos_replay_threaded_matches_reference():
    """The reference's threaded chaos replay: transient compile and
    device faults, a poisoned query and a hang.  Rows equal the oracle
    minus exactly the offender, with the reference's retries, quarantine
    and injection counts; the hang degrades on the CPU."""
    _ref, port, out = _both(CHAOS, threaded=True, retry=CHAOS_RETRY)
    led = port.stats.ledger
    assert led.retries > 0
    assert led.quarantined_keys() == [("a", 5)]
    assert led.timed_out_flushes >= 1 and led.degraded_flushes >= 1
    want = _without({("a", 5)})
    for n in TABLES:
        np.testing.assert_array_equal(out[n], want[n])
    inj = port.report()["faults"]["injected"]
    assert inj["compile"] >= 2 and inj["device"] >= 1
    assert inj["poison"] >= 1 and inj["hang"] >= 1


def test_chaos_replay_card_branch_keeps_the_cpu_servers_ledger():
    """The same replay on the card's branch: the hang raises instead of
    degrading, yet the rows, retries and quarantined keys equal the CPU
    server's."""
    cpu = _server("port", CHAOS, threaded=True, retry=CHAOS_RETRY)
    cpu_out, _ = _replay(cpu)
    card = _server("port", CHAOS, threaded=True, retry=CHAOS_RETRY, card=True)
    card_out, timeouts = _replay(card)
    assert timeouts >= 1
    for n in TABLES:
        np.testing.assert_array_equal(card_out[n], cpu_out[n])
    cl, kl = cpu.stats.ledger, card.stats.ledger
    assert (kl.retries, kl.quarantined_keys()) == (cl.retries, cl.quarantined_keys())
    assert kl.degraded_flushes == 0 and kl.timed_out_flushes >= 1


def test_poison_quarantines_only_offending_producer():
    plan_specs = [("poison", {"table": "a", "seq": 3, "producer": "A"})]
    srv = _server("port", plan_specs, threaded=True, retry={"max_retries": 1, **FAST})
    assert srv._injector.plan.poisoned_by_producer() == [("A", "a", 3)]
    for lab in ("A", "B"):
        srv.register_producer(lab)
    errs = []

    def body(lab):
        try:
            for q in STREAMS["a"]:
                srv.submit("a", q, producer=lab)
        except Exception as e:  # re-raised below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(lab,), daemon=True) for lab in ("A", "B")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "producer thread wedged"
    assert not errs, errs
    out = {lab: srv.drain(producer=lab) for lab in ("A", "B")}
    srv.close()
    led = srv.stats.ledger
    assert led.quarantined_keys_by_producer() == [("A", "a", 3)]
    keep = [i for i in range(len(STREAMS["a"])) if i != 3]
    np.testing.assert_array_equal(_rows(out["A"]["a"]), ORACLE["a"][keep])
    np.testing.assert_array_equal(_rows(out["B"]["a"]), ORACLE["a"])
