"""Tiered host↔device storage of the port (``repro_torch.serve.tiers``
and the tier half of ``serve.ShardedEmbeddingServer``) on the CPU
against ``repro``'s.

A capacity-bounded server must drain rows bit-identical to the
reference's tiered server (``mesh=None``) and to a gather+sum of the
logical tables on integer-valued tables, route the same queries to the
host, flush the host queue as often, and page in and out the same tiles.
Mirrors ``tests/test_tiers.py``; the paging math itself is held against
the reference in ``tests/test_torch_replan.py``.
"""

import json

import numpy as np
import pytest
import torch

from repro.data import zipf_queries
from repro.launch import serve_sharded as jax_launch
from repro.serve import ReplanConfig as JaxReplan
from repro.serve import RetryPolicy as JaxRetry
from repro.serve import ShardedEmbeddingServer as JaxServer
from repro.serve.faults import FaultPlan as JaxFaultPlan
from repro.serve.tiers import HostFetchQueue as JaxQueue
from repro.serve.tiers import ResidencyIndex as JaxResidency
from repro.serve.tiers import TierConfig as JaxTiers
from repro_torch.convert import tables_from_numpy
from repro_torch.dist import PagingPolicy, compute_plan_patch
from repro_torch.launch import serve_sharded as torch_launch
from repro_torch.serve import (
    FaultPlan,
    HostFetchQueue,
    ReplanConfig,
    ResidencyIndex,
    RetryPolicy,
    ShardedEmbeddingServer,
    TierConfig,
)
from repro_torch.serve.tiers import gather_cold_rows, sum_cold_rows

EQ1_BATCH = 64
TIER_STATS = ("hot_queries", "host_queries", "host_flushes", "host_deadline_flushes",
              "sync_cold_batches", "fetched_tiles", "evicted_tiles", "paging_bytes")
SERVE_STATS = ("replans", "rebases", "patched_tiles", "barrier_flushes", "batches",
               "queries")
PAGING_REPLAN = {"threshold": 0.2, "half_life": 4, "min_queries": 32}


def _int_table(rows, dim, seed):
    """Integer-valued f32 table: partial sums are exact in float32."""
    return np.random.default_rng(seed).integers(-8, 9, size=(rows, dim)).astype(np.float32)


def _oracle(table, queries):
    """Host gather+sum over each query's distinct rows."""
    return np.stack([table[np.unique(np.asarray(q, np.int64))].sum(axis=0)
                     for q in queries])


def _setup(seed, rows=320, dim=128):
    tables = {"a": _int_table(rows, dim, seed), "b": _int_table(rows, dim, seed + 1)}
    histories = {n: zipf_queries(rows, 64, 5.0, seed=seed + i)
                 for i, n in enumerate(tables)}
    return tables, histories


def _pair(tables, histories, *, tiers, replan=None, faults=(), retry=None,
          bf16=False, **kw):
    """(reference, port) servers of one configuration; ``tiers``,
    ``replan`` and ``retry`` are keyword dicts, ``faults`` a list of
    ``(kind, kwargs)`` specs of one fault plan per package."""
    import ml_dtypes

    kw = dict(num_shards=2, q_block=4, group_size=16, batch_size=16, **kw)

    def mk(Server, Tiers, Replan, Retry, Plan, tabs, **extra):
        plan = None
        if faults:
            plan = Plan([], seed=0)
            for kind, spec in faults:
                plan.add(kind, **spec)
        return Server(
            tabs, histories,
            tiers=Tiers(**tiers) if tiers is not None else None,
            replan=Replan(**replan) if replan is not None else None,
            retry=Retry(**retry) if retry is not None else None,
            faults=plan, **kw, **extra,
        )

    if bf16:
        ref_tabs = {n: t.astype(ml_dtypes.bfloat16) for n, t in tables.items()}
        port_tabs = {n: torch.from_numpy(t).to(torch.bfloat16) for n, t in tables.items()}
    else:
        ref_tabs, port_tabs = tables, tables_from_numpy(tables, "cpu")
    ref = mk(JaxServer, JaxTiers, JaxReplan, JaxRetry, JaxFaultPlan, ref_tabs)
    port = mk(ShardedEmbeddingServer, TierConfig, ReplanConfig, RetryPolicy, FaultPlan,
              port_tabs, device="cpu")
    return ref, port


def _rows(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _assert_tiers_equal(ref, port):
    rs, ps = ref.stats.summary(), port.stats.summary()
    for key in TIER_STATS:
        assert rs["tiers"][key] == ps["tiers"][key], key
    for key in SERVE_STATS:
        assert rs[key] == ps[key], key
    assert ref.report()["tiers"] == port.report()["tiers"]
    assert ref._capacity_tiles == port._capacity_tiles
    assert int(port.shard_images.shape[1]) == port._capacity_tiles
    np.testing.assert_array_equal(port.plan.resident_group, ref.plan.resident_group)
    np.testing.assert_array_equal(port.plan.local_tile_of, ref.plan.local_tile_of)
    np.testing.assert_array_equal(port.shard_images.float().numpy(),
                                  np.asarray(ref.shard_images, np.float32))


def _cold_rows_of(server, table):
    gof = server._residency._fused_group_of_row[table]
    return np.nonzero(np.isin(gof, server.plan.cold_groups))[0]


# ------------------------------------------------------ host-side units --


def test_tier_config_matches_reference():
    for bad in ({}, {"capacity_tiles": 8, "capacity_frac": 0.5},
                {"capacity_frac": 1.5}, {"capacity_tiles": 8, "hysteresis": 0.9}):
        for Tiers in (TierConfig, JaxTiers):
            with pytest.raises(ValueError):
                Tiers(**bad)
    for kw in ({"capacity_frac": 0.25}, {"capacity_tiles": 7, "hysteresis": 1.1,
                                         "max_fetch_tiles": 3, "min_fetch_load": 0.5}):
        port, ref = TierConfig(**kw), JaxTiers(**kw)
        for depth in (1, 2, 40, 35_232):
            assert port.resolve_capacity(depth) == ref.resolve_capacity(depth)
        pp, rp = port.paging_policy(10), ref.paging_policy(10)
        assert isinstance(pp, PagingPolicy)
        for f in ("capacity_tiles", "hysteresis", "max_fetch_tiles", "min_fetch_load"):
            assert getattr(pp, f) == getattr(rp, f), f


def test_residency_index_and_host_queue_match_reference():
    tables, histories = _setup(29)
    ref, port = _pair(tables, histories, tiers={"capacity_frac": 0.5})
    gofs = {s.name: port._residency._fused_group_of_row[s.name] for s in port.plan.tables}
    idx, jidx = ResidencyIndex(port.plan, gofs), JaxResidency(ref.plan, gofs)
    assert idx.any_cold and jidx.any_cold
    rng = np.random.default_rng(0)
    entries = [(n, i, rng.integers(0, 320, size=rng.integers(0, 6)))
               for i, n in enumerate("abab" * 8)]
    for n, _, q in entries:
        assert idx.is_resident(n, q) == jidx.is_resident(n, q)
        np.testing.assert_array_equal(idx.groups_of(n, q), jidx.groups_of(n, q))
    np.testing.assert_array_equal(idx.host_group_loads(entries),
                                  jidx.host_group_loads(entries))
    # a query's repeated rows count once per group
    r = int(_cold_rows_of(port, "a")[0])
    loads = idx.host_group_loads([("a", 0, np.asarray([r, r, r]))])
    assert loads.sum() == 1.0
    queues = (HostFetchQueue(2, 10), JaxQueue(2, 10))
    for q in queues:
        assert q.due(0) is None
        q.push("t", 0, np.asarray([1]), 5)
        assert q.due(5) is None and q.due(15) == "deadline"
        q.push("t", 1, np.asarray([2]), 6)
        assert q.due(6) == "batch"
    assert queues[0].state() == queues[1].state()
    assert [e[:2] for e in queues[0].take()] == [e[:2] for e in queues[1].take()]
    assert queues[0].due(99) is None and queues[0].state() == queues[1].state()


def test_sum_cold_rows_sums_runs_in_float32_and_zeros_empty_queries():
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((9, 16)).astype(np.float32)
    lengths = np.asarray([0, 3, 0, 1, 5, 0])
    got = sum_cold_rows(rows, lengths)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    for i, (a, n) in enumerate(zip(starts, lengths)):
        want = rows[a:a + n].sum(axis=0) if n else np.zeros(16, np.float32)
        np.testing.assert_array_equal(got[i], want)
    assert got.dtype == np.float32
    fused = rng.standard_normal((4, 8, 16)).astype(np.float32)
    np.testing.assert_array_equal(gather_cold_rows(fused, np.asarray([3, 0]),
                                                   np.asarray([7, 2])),
                                  fused[[3, 0], [7, 2]])


# ---------------------------------------- tiered server ≡ reference --


POLICIES = [("global", False), ("per-shard", False), ("deadline", False),
            ("owner-set", False), ("owner-set", True)]


@pytest.mark.parametrize("policy,threaded", POLICIES)
def test_capped_server_matches_reference(policy, threaded):
    tables, histories = _setup(11)
    ref, port = _pair(tables, histories, tiers={"capacity_frac": 0.5},
                      flush_policy=policy, threaded=threaded)
    assert port.plan.cold_groups.size > 0, "the cap did not bite"
    assert port.replan_cfg is not None and ref.replan_cfg is not None
    rng = np.random.default_rng(11)
    stream = [("a" if i % 2 else "b", rng.integers(0, 320, size=rng.integers(1, 6)).tolist())
              for i in range(180)]
    if policy == "global":
        by = {n: [q for t, q in stream if t == n] for n in ("a", "b")}
        got, want = port.serve(by), ref.serve(by)
    else:
        for n, q in stream:
            port.submit(n, q)
            ref.submit(n, q)
        got, want = port.drain(), ref.drain()
        port.close(), ref.close()
    assert set(got) == set(want) == {"a", "b"}
    for n in got:
        np.testing.assert_array_equal(_rows(got[n]), _rows(want[n]))
        np.testing.assert_array_equal(
            _rows(got[n]), _oracle(tables[n], [q for t, q in stream if t == n]))
    _assert_tiers_equal(ref, port)
    ts = port.stats.tier_summary()
    assert ts["host_queries"] > 0 and ts["hot_queries"] > 0
    assert ts["hot_queries"] + ts["host_queries"] == len(stream)


@pytest.mark.parametrize("policy,threaded", [("global", False), ("deadline", False),
                                             ("owner-set", True)])
def test_paging_replay_fetches_evicts_like_reference(policy, threaded):
    """Skewed traffic onto cold groups pages them in and evicts colder
    residents at barriers, with every row, patch and paging counter equal
    to the reference's and the hot tier's depth fixed throughout."""
    tables, histories = _setup(7)
    ref, port = _pair(tables, histories, tiers={"capacity_frac": 0.5, "hysteresis": 1.1},
                      replan=PAGING_REPLAN, flush_policy=policy, threaded=threaded)
    cold_rows = _cold_rows_of(port, "a")
    rng = np.random.default_rng(7)
    depths, got, want = set(), [], []
    for i in range(480):
        if i % 3:
            q = rng.choice(cold_rows[:40], size=rng.integers(1, 5)).tolist()
        else:
            q = rng.integers(0, 320, size=rng.integers(1, 5)).tolist()
        g, w = port.submit("a", q), ref.submit("a", q)
        if (i + 1) % 96 == 0 and policy != "global":
            g, w = port.drain(), ref.drain()
        if g:
            got.append(_rows(g["a"]))
            want.append(_rows(w["a"]))
        depths.add(int(port.shard_images.shape[1]))
    g, w = port.flush(), ref.flush()
    if g:
        got.append(_rows(g["a"]))
        want.append(_rows(w["a"]))
    port.close(), ref.close()
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    ts = port.stats.tier_summary()
    assert ts["fetched_tiles"] > 0 and ts["evicted_tiles"] > 0, ts
    assert ts["paging_bytes"] == ts["fetched_tiles"] * port._tile_bytes
    assert depths == {port._capacity_tiles}
    assert int(port.plan.local_num_tiles.max()) <= port._capacity_tiles
    _assert_tiers_equal(ref, port)
    assert ref.report()["replan"] == port.report()["replan"]


def test_fetch_failure_keeps_groups_cold_and_drain_survives():
    """Every patch apply fails at the injector's patch seam: nothing pages
    in, the cold groups keep taking the host path, the ledger counts the
    same failures and drops as the reference's, and every row survives."""
    tables, histories = _setup(19)
    ref, port = _pair(tables, histories, tiers={"capacity_frac": 0.5, "hysteresis": 1.1},
                      replan=PAGING_REPLAN, flush_policy="deadline",
                      retry={"patch_retries": 1, "backoff_base": 0.0, "jitter": 0.0},
                      faults=[("patch", {"times": 100})])
    cold = port.plan.cold_groups.copy()
    cold_rows = _cold_rows_of(port, "a")
    rng = np.random.default_rng(19)
    got, want = [], []
    for i in range(300):
        if i % 3:
            q = rng.choice(cold_rows[:40], size=rng.integers(1, 5)).tolist()
        else:
            q = rng.integers(0, 320, size=rng.integers(1, 5)).tolist()
        port.submit("a", q)
        ref.submit("a", q)
        if (i + 1) % 100 == 0:
            got.append(_rows(port.drain()["a"]))
            want.append(_rows(ref.drain()["a"]))
    port.close(), ref.close()
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))
    pl, rl = port.stats.ledger, ref.stats.ledger
    assert pl.patch_failures > 0 and pl.patches_dropped > 0
    assert (pl.patch_failures, pl.patches_dropped) == (rl.patch_failures, rl.patches_dropped)
    assert port.stats.fetched_tiles == 0
    np.testing.assert_array_equal(port.plan.cold_groups, cold)
    _assert_tiers_equal(ref, port)
    assert port.report()["faults"] == ref.report()["faults"]


def test_resident_query_survives_patch_barrier_during_routing():
    """Stale residency: a query judged resident whose own routing's host
    flush hits a patch barrier that evicts its group must take the host
    path under the post-patch residency, not raise in the scheduler."""
    tables, histories = _setup(47)
    ref, port = _pair(tables, histories,
                      tiers={"capacity_frac": 0.5, "host_batch": 64, "host_deadline": 8},
                      flush_policy="per-shard")
    plan = port.plan
    cold = plan.cold_groups
    resident = np.nonzero((plan.shard_of_group >= 0) & ~plan.replicated_group)[0]
    gof = port._residency._fused_group_of_row["a"]
    victim = int(resident[np.isin(resident, gof)][0])
    loads = np.zeros(plan.num_groups, dtype=np.float64)
    loads[resident] = 2.0
    loads[np.asarray(plan.replicated_group)] = 50.0
    loads[cold] = 50.0
    loads[victim] = 0.01
    pol = PagingPolicy(capacity_tiles=port._capacity_tiles, hysteresis=1.1)
    patch = compute_plan_patch(plan, loads, eq1_batch=EQ1_BATCH, paging=pol)
    assert victim in patch.evicted, patch.summary()
    from repro.dist import compute_plan_patch as jax_patch
    from repro.dist.replan import PagingPolicy as JaxPaging
    jpatch = jax_patch(ref.plan, loads, eq1_batch=EQ1_BATCH,
                       paging=JaxPaging(capacity_tiles=ref._capacity_tiles, hysteresis=1.1))
    q0 = _cold_rows_of(port, "a")[:2].tolist()
    q1 = np.nonzero(gof == victim)[0][:3].tolist()
    for srv, p in ((port, patch), (ref, jpatch)):
        srv.submit("a", q0)
        srv._tick += 100           # the queued cold query is past its deadline
        srv._staged = p            # and a patch waits for the next barrier
        srv.submit("a", q1)        # the host flush → barrier → q1 went cold
        assert srv.stats.barrier_flushes >= 1
        assert not srv._residency.is_resident("a", np.asarray(q1, dtype=np.int64))
        assert srv.stats.host_queries >= 2
    got, want = port.drain(), ref.drain()
    port.close(), ref.close()
    np.testing.assert_array_equal(_rows(got["a"]), _rows(want["a"]))
    np.testing.assert_array_equal(_rows(got["a"]), _oracle(tables["a"], [q0, q1]))
    _assert_tiers_equal(ref, port)


def test_host_queue_deadline_forces_flush_in_hot_stream():
    tables, histories = _setup(31)
    ref, port = _pair(tables, histories,
                      tiers={"capacity_frac": 0.5, "host_batch": 64, "host_deadline": 20},
                      flush_policy="deadline")
    gof = port._residency._fused_group_of_row["a"]
    cold_rows = _cold_rows_of(port, "a")
    hot_rows = np.nonzero(~np.isin(gof, port.plan.cold_groups))[0]
    rng = np.random.default_rng(31)
    stream = [cold_rows[:2].tolist()] + [rng.choice(hot_rows, size=3).tolist()
                                        for _ in range(30)]
    for q in stream:
        port.submit("a", q)
        ref.submit("a", q)
    assert port.stats.host_deadline_flushes >= 1
    assert len(port._host_queue) == 0
    got, want = port.drain(), ref.drain()
    port.close(), ref.close()
    np.testing.assert_array_equal(_rows(got["a"]), _rows(want["a"]))
    np.testing.assert_array_equal(_rows(got["a"]), _oracle(tables["a"], stream))
    _assert_tiers_equal(ref, port)


# -------------------------------------------- the cold tier's compute --


def test_cold_rows_read_from_master_image_equal_logical_gather_sum():
    """The host path reads each row from the master image (a permutation
    of the tables, so the same bits) and sums it in row order: on
    non-integer f32 tables its rows equal a gather+sum of the logical
    table and the reference's host rows bit for bit, empty bags zero."""
    rows, dim = 320, 128
    rng = np.random.default_rng(5)
    tables = {n: rng.standard_normal((rows, dim)).astype(np.float32) for n in ("a", "b")}
    histories = {n: zipf_queries(rows, 64, 5.0, seed=i) for i, n in enumerate(tables)}
    ref, port = _pair(tables, histories, tiers={"capacity_tiles": 1})
    entries = [(n, i, rng.integers(0, rows, size=rng.integers(0, 12)).tolist())
               for i, n in enumerate("aabab" * 6)]
    got = port._cold_rows(entries).numpy()
    for (n, _, q), row in zip(entries, got):
        ids = np.unique(np.asarray(q, np.int64))
        want = tables[n][ids].sum(axis=0) if ids.size else np.zeros(dim, np.float32)
        np.testing.assert_array_equal(row, want)
        np.testing.assert_array_equal(row, ref._cold_row(n, q))
    # the host master image holds the tables' bits; no logical host copy
    # is kept beside it
    assert port._fused is not None and port._host_tables is None


def test_sync_serve_assembles_hot_and_cold_rows_like_reference():
    """A ``"global"`` serve with hot and cold queries in one table and an
    all-cold table: the rows are assembled by position, equal to the
    reference's, with one sync cold batch each."""
    tables, histories = _setup(13)
    ref, port = _pair(tables, histories, tiers={"capacity_frac": 0.5})
    gof = port._residency._fused_group_of_row
    hot_a = np.nonzero(~np.isin(gof["a"], port.plan.cold_groups))[0]
    cold_a, cold_b = _cold_rows_of(port, "a"), _cold_rows_of(port, "b")
    by = {"a": [hot_a[:3].tolist(), cold_a[:2].tolist(), [], hot_a[3:5].tolist(),
                cold_a[2:6].tolist()],
          "b": [cold_b[:4].tolist(), cold_b[4:5].tolist()]}
    got, want = port.serve(by), ref.serve(by)
    for n in by:
        assert got[n].dtype == torch.float32
        np.testing.assert_array_equal(_rows(got[n]), _rows(want[n]))
        np.testing.assert_array_equal(_rows(got[n]), _oracle(tables[n], by[n]))
    _assert_tiers_equal(ref, port)
    assert port.stats.sync_cold_batches == 1
    # an all-cold batch serves without a compile
    got, want = port.serve({"b": by["b"]}), ref.serve({"b": by["b"]})
    np.testing.assert_array_equal(_rows(got["b"]), _rows(want["b"]))
    _assert_tiers_equal(ref, port)


def test_bf16_tiered_server_matches_reference():
    """bf16 tables: the port sums cold rows in float32 and rounds once;
    on integer-valued tables whose sums stay within ±256 both are exact."""
    tables, histories = _setup(17)
    ref, port = _pair(tables, histories, tiers={"capacity_frac": 0.5},
                      flush_policy="per-shard", bf16=True)
    assert port.shard_images.dtype == torch.bfloat16
    rng = np.random.default_rng(17)
    stream = [("a" if i % 2 else "b", rng.integers(0, 320, size=rng.integers(1, 6)).tolist())
              for i in range(120)]
    for n, q in stream:
        port.submit(n, q)
        ref.submit(n, q)
    got, want = port.drain(), ref.drain()
    port.close(), ref.close()
    for n in got:
        assert got[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(_rows(got[n]), _rows(want[n]))
    assert port.stats.host_queries > 0
    _assert_tiers_equal(ref, port)


def test_tiers_imply_replan_and_close_reports_host_pending():
    tables, histories = _setup(23)
    ref, port = _pair(tables, histories,
                      tiers={"capacity_frac": 0.5, "host_batch": 64},
                      flush_policy="per-shard")
    assert port.replan_cfg == ReplanConfig() and port.tracker is not None
    assert port.report()["replan"]["image_capacity"] == port._capacity_tiles
    for srv in (port, ref):
        srv.submit("a", _cold_rows_of(port, "a")[:2].tolist())
        srv.close()
        assert srv.stats.ledger.lost_work["host_pending"] == 1
    got, want = port.drain(), ref.drain()
    np.testing.assert_array_equal(_rows(got["a"]), _rows(want["a"]))
    with pytest.raises(TypeError, match="ShardMesh"):
        ShardedEmbeddingServer(tables_from_numpy(tables, "cpu"), histories, device="cpu",
                               mesh=object(), tiers=TierConfig(capacity_frac=0.5))


# ------------------------------------------------------------ launcher --


LAUNCH = ["--shards", "2", "--tables", "2", "--rows", "512", "--history", "512",
          "--requests", "192", "--batch-size", "32"]


@pytest.mark.parametrize("extra", [
    ["--capacity-frac", "0.5", "--drift", "--flush-policy", "deadline"],
    ["--inject", "compile:1,poison:1", "--watchdog", "1.0", "--flush-policy", "per-shard"],
])
def test_launcher_report_blocks_match_reference(extra, capsys):
    """The launcher's tier and fault flags: the port's report carries the
    reference launcher's ``tiers`` / ``faults`` blocks and serve
    counters, with equal routing, paging and quarantine."""
    port = torch_launch.main(torch_launch.parse_args(["--device", "cpu"] + LAUNCH + extra))
    jax_launch.main(jax_launch.parse_args(["--emulate"] + LAUNCH + extra))
    ref = json.loads(capsys.readouterr().out)
    for block, flag in (("tiers", "--capacity-frac"), ("faults", "--inject")):
        assert (block in port) == (block in ref) == (flag in extra)
        if block in ref:
            assert set(port[block]) == set(ref[block])
        assert set(port["serve"][block]) == set(ref["serve"][block])
    if "tiers" in ref:
        assert port["tiers"] == ref["tiers"]
        for key in TIER_STATS:
            assert port["serve"]["tiers"][key] == ref["serve"]["tiers"][key], key
        assert port["serve"]["tiers"]["host_queries"] > 0
    if "faults" in ref:
        assert port["faults"]["plan"] == ref["faults"]["plan"]
        assert port["faults"]["injected"] == ref["faults"]["injected"]
        q = [row[:2] for row in port["serve"]["faults"]["quarantined"]]
        assert q == [row[:2] for row in ref["serve"]["faults"]["quarantined"]]
        assert q == port["faults"]["plan"]["poisoned"]
