"""The port's correctness tooling (``repro_torch.analysis``) on the CPU
against ``repro.analysis``.

Mirrors ``tests/test_analysis.py``: each deliberately corrupted plan,
patch and server fixture is built once from numpy seeds and must be
rejected by both packages' validators with the same message, while every
REAL plan and patch of the replan and paging pipelines, and a live
server, passes both (no false positives); the port's three server-check
differences (master image, host tables, a mesh rank's image) each have
a case.  The lock pass must bless the port's tree with the reference's
locks and edges and report the reference's findings on crafted sources;
its runtime monitor must observe only blessed, statically known edges
under the port's multiproducer stress.  The lint must run clean on the
port's tree and catch each rule's crafted violation, each draw from
torch's global generator included.
"""

import dataclasses
import threading
import types

import numpy as np
import pytest

import repro.analysis as janalysis
import repro.core as jcore
import repro.dist as jdist
from repro.analysis.invariants import InvariantViolation as JaxViolation
from repro.data import zipf_queries
from repro.serve import ShardedEmbeddingServer as JaxServer
from repro_torch import core
from repro_torch.analysis import invariants as pinv
from repro_torch.analysis import (
    InvariantViolation,
    LockMonitor,
    LockOrderError,
    analyze_locks,
    monitor_server,
    run_lint,
    validate_server_state,
)
from repro_torch.analysis.races import BLESSED_LOCK_ORDER, OrderGraph
from repro_torch.convert import tables_from_numpy
from repro_torch.dist import (
    PagingPolicy,
    apply_plan_patch,
    compute_plan_patch,
    plan_shards,
)
from repro_torch.dist.replan import PlanPatch
from repro_torch.serve import ShardedEmbeddingServer, TierConfig

EQ1_BATCH = 64
ROWS, DIM = 192, 128
PLAN_FIELDS = ("replicated_group", "shard_of_group", "shard_of_tile",
               "local_tile_of", "local_num_tiles", "group_load", "group_copies")


def _int_table(rows, dim, seed):
    """Integer-valued f32 table: partial sums are exact in float32."""
    return np.random.default_rng(seed).integers(
        -8, 9, size=(rows, dim)
    ).astype(np.float32)


def _plan(seed=3, S=2, capacity_frac=None):
    """The port's plan, held equal to the reference's from the same seed."""
    hist = zipf_queries(ROWS, 48, 6.0, seed=seed)
    plans = []
    for pkg, plan_shards_fn in ((core, plan_shards), (jcore, jdist.plan_shards)):
        g = pkg.build_cooccurrence(hist, ROWS)
        grouping = pkg.correlation_aware_grouping(g, 16)
        rplan = pkg.plan_replication(grouping, g.freq, EQ1_BATCH)
        layout = pkg.build_layout(grouping, rplan, DIM)
        gfreq = grouping.group_freq(g.freq)
        cap = None
        if capacity_frac is not None:
            uncapped = plan_shards_fn([layout], [rplan], S, group_freqs=[gfreq])
            cap = max(2, int(uncapped.max_local_tiles * capacity_frac))
        plans.append(plan_shards_fn([layout], [rplan], S, group_freqs=[gfreq],
                                    capacity_tiles=cap))
    port, ref = plans
    assert port.capacity_tiles == ref.capacity_tiles
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    return port


def _both_reject(check, *args, match):
    """Both packages' validator raises, with one message."""
    with pytest.raises(InvariantViolation, match=match) as port:
        getattr(pinv, check)(*args)
    with pytest.raises(JaxViolation, match=match) as ref:
        getattr(janalysis, check)(*args)
    assert str(port.value) == str(ref.value)


def _both_accept(check, *args):
    getattr(pinv, check)(*args)
    getattr(janalysis, check)(*args)


_TABLES = {"a": _int_table(ROWS, DIM, 11), "b": _int_table(ROWS, DIM, 12)}
_HISTORIES = {"a": zipf_queries(ROWS, 48, 5.0, seed=13),
              "b": zipf_queries(ROWS, 48, 5.0, seed=14)}
_SERVER_KW = dict(num_shards=2, q_block=4, group_size=16, batch_size=8)


def _server(**kw):
    kw.setdefault("flush_policy", "per-shard")
    return ShardedEmbeddingServer(
        tables_from_numpy(_TABLES, "cpu"), _HISTORIES, device="cpu",
        **_SERVER_KW, **kw,
    )


def _jax_server(**kw):
    kw.setdefault("flush_policy", "per-shard")
    return JaxServer(_TABLES, _HISTORIES, **_SERVER_KW, **kw)


# ------------------------------------------------ invariants: rejects --


def test_fresh_plans_validate_clean():
    for S in (1, 2, 4):
        _both_accept("validate_plan", _plan(seed=S, S=S))
    _both_accept("validate_plan", _plan(seed=7, S=2, capacity_frac=0.5))


def test_duplicate_slot_rejected():
    sp = _plan()
    lto = sp.local_tile_of.copy()
    held = np.nonzero(lto[0] >= 0)[0]
    assert held.size >= 2
    lto[0, held[1]] = lto[0, held[0]]  # two tiles share one local slot
    bad = dataclasses.replace(sp, local_tile_of=lto)
    _both_reject("validate_plan", bad, match="slot uniqueness violated")


def test_mutated_group_copies_rejected():
    sp = _plan()
    copies = sp.group_copies.copy()
    copies[0] += 1  # the fused tile space is frozen at plan build
    bad = dataclasses.replace(sp, group_copies=copies)
    _both_reject("validate_plan", bad, match="frozen tile space was mutated")


def test_resident_but_evicted_group_rejected():
    sp = _plan(capacity_frac=0.5)
    g = int(np.nonzero(sp.replicated_group)[0][0])
    patch = PlanPatch(
        promoted=[], demoted=[], dma=[], freed=[],
        new_capacity=int(sp.capacity_tiles),
        drifted_load=sp.group_load.copy(),
        evicted=[g], evicted_tiles=int(sp.group_copies[g]),
    )
    _both_reject("validate_patch", sp, patch, match="not sharded-once resident")


def test_evict_fetch_overlap_rejected():
    sp = _plan(capacity_frac=0.5)
    g = int(sp.cold_groups[0])
    patch = PlanPatch(
        promoted=[], demoted=[], dma=[], freed=[],
        new_capacity=int(sp.capacity_tiles),
        drifted_load=sp.group_load.copy(),
        fetched=[(g, 0)], evicted=[g],
    )
    _both_reject("validate_patch", sp, patch, match="evict/fetch disjointness")


def test_wrong_dma_count_and_slot_collision_rejected():
    sp = _plan()
    dload = sp.group_load[::-1].copy()
    patch = compute_plan_patch(sp, dload, eq1_batch=EQ1_BATCH)
    assert patch.promoted, "the reversed load must promote at this seed"
    # drop one promotion DMA: the Σ copies·(S-1) accounting must fire
    short = dataclasses.replace(patch, dma=patch.dma[:-1])
    _both_reject("validate_patch", sp, short, match="promotion DMAs")
    # collide two DMAs into one (shard, slot): the simulation must fire
    assert len(patch.dma) >= 2
    s0, slot0, _t0 = patch.dma[0]
    _s1, _slot1, t1 = patch.dma[1]
    collided = dataclasses.replace(
        patch, dma=[patch.dma[0], (s0, slot0, t1)] + patch.dma[2:]
    )
    _both_reject("validate_patch", sp, collided, match="collides|already holds")


def test_gseq_overflow_rejected():
    servers = (_server(threaded=False), _jax_server(threaded=False))
    try:
        for srv in servers:
            reg = srv._registry
            pid = reg.register("p0")
            # force the NEXT stamp past the packed int64 capacity
            reg._next[pid]["a"] = ((1 << 63) - 1) // reg.stride + 1
        msgs = []
        for srv, err in zip(servers, (InvariantViolation, JaxViolation)):
            check = (validate_server_state if err is InvariantViolation
                     else janalysis.validate_server_state)
            with pytest.raises(err, match="overflows the packed gseq capacity") as e:
                check(srv)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    finally:
        for srv in servers:
            srv.close()


# ------------------------------------- invariants: no false positives --


@pytest.mark.parametrize("seed,S", [(0, 1), (1, 2), (2, 4)])
def test_real_replan_patches_validate_clean(seed, S):
    sp = _plan(seed=seed, S=S)
    dload = sp.group_load[::-1].copy()
    patch = compute_plan_patch(sp, dload, eq1_batch=EQ1_BATCH)
    _both_accept("validate_patch", sp, patch)
    _both_accept("validate_plan", apply_plan_patch(sp, patch))


def test_real_paging_patches_validate_clean():
    sp = _plan(seed=5, S=2, capacity_frac=0.5)
    pol = PagingPolicy(capacity_tiles=int(sp.capacity_tiles), hysteresis=1.2)
    # rotate hotness onto the cold set so the patch pages both ways
    dload = sp.group_load[::-1].copy()
    patch = compute_plan_patch(sp, dload, eq1_batch=EQ1_BATCH, paging=pol)
    assert patch.fetched
    _both_accept("validate_patch", sp, patch)
    sp2 = apply_plan_patch(sp, patch)
    _both_accept("validate_plan", sp2)
    # and one more round on the patched (hole-y) plan
    patch2 = compute_plan_patch(sp2, sp.group_load.copy(),
                                eq1_batch=EQ1_BATCH, paging=pol)
    assert patch2.fetched and patch2.evicted
    _both_accept("validate_patch", sp2, patch2)
    _both_accept("validate_plan", apply_plan_patch(sp2, patch2))


def test_live_server_state_validates_clean():
    srv = _server(threaded=True)
    try:
        validate_server_state(srv)
        rng = np.random.default_rng(0)
        for i in range(24):
            srv.submit("a" if i % 2 == 0 else "b",
                       rng.integers(0, ROWS, size=4), producer=f"p{i % 3}")
        srv.drain()  # quiesced validation runs inside via RECROSS_VALIDATE
        validate_server_state(srv, quiesced=True)
    finally:
        srv.close()


def test_quiesced_drain_runs_the_server_validator(monkeypatch):
    # the drain hook is live: a corrupted buffer count surfaces at the
    # next full quiescence, and only with RECROSS_VALIDATE set
    srv = _server(threaded=False)
    try:
        srv.submit("a", [1, 2, 3])
        srv._buffered = 5  # the async engine never reads it
        monkeypatch.setenv("RECROSS_VALIDATE", "0")
        srv.drain()
        monkeypatch.setenv("RECROSS_VALIDATE", "1")
        srv.submit("a", [4, 5])
        with pytest.raises(InvariantViolation, match="_buffered=5"):
            srv.drain()
    finally:
        srv._buffered = 0
        srv.close()


# --------------------------------- invariants: the port's differences --


def test_tiered_server_without_master_image_rejected():
    srv = _server(tiers=TierConfig(capacity_frac=0.5))
    try:
        validate_server_state(srv)
        assert srv.plan.cold_groups.size
        srv._fused = None  # cold rows and fetches read the master image
        with pytest.raises(InvariantViolation, match="host master image missing"):
            validate_server_state(srv)
        srv._fused = np.zeros((srv.plan.num_tiles - 1, 1, 1), np.float32)
        with pytest.raises(InvariantViolation,
                           match=f"master image has {srv.plan.num_tiles - 1} tiles"):
            validate_server_state(srv)
    finally:
        srv.close()


def test_server_without_replan_validates_without_master_image():
    for policy in ("global", "per-shard"):
        srv = _server(flush_policy=policy)
        try:
            assert srv._fused is None and srv.replan_cfg is None
            # the logical host tables are kept only on a CPU async server
            assert (srv._host_tables is None) == (policy == "global")
            validate_server_state(srv)
            if srv._host_tables is not None:
                srv._host_tables = dict(srv._host_tables, a=_TABLES["a"][:-1])
                with pytest.raises(InvariantViolation,
                                   match=f"host table 'a' has {ROWS - 1} rows"):
                    validate_server_state(srv)
        finally:
            srv.close()


def test_mesh_rank_image_validates():
    srv = _server(threaded=False)
    try:
        srv.shard_images = srv.shard_images[:1]  # rank 0's (1, depth, ...) shard
        with pytest.raises(InvariantViolation,
                           match="shard image stack has 1 shards, plan has 2"):
            validate_server_state(srv)
        srv.mesh = types.SimpleNamespace(rank=0, size=2)
        validate_server_state(srv)
        srv.shard_images = srv.shard_images.expand(2, -1, -1, -1)
        with pytest.raises(InvariantViolation, match="a rank holds 1"):
            validate_server_state(srv)
    finally:
        srv.mesh = None
        srv.close()


# ------------------------------------------------------ lock analyzer --


def test_static_lock_pass_blesses_current_tree():
    report = analyze_locks()
    assert report.findings() == []
    # the four coordinated locks are all discovered
    assert "ShardedEmbeddingServer" in report.locks
    assert {"_stamp_lock", "_engine_lock", "_results_lock"} <= (
        report.locks["ShardedEmbeddingServer"]
    )
    assert "_lock" in report.locks.get("ProducerRegistry", set())
    # every nesting edge among the blessed locks runs strictly forward
    idx = {n: i for i, n in enumerate(BLESSED_LOCK_ORDER)}
    for e in report.edges:
        if e.held == e.acquired:
            continue  # RLock reentrancy self-edge, allowed
        if e.held in idx and e.acquired in idx:
            assert idx[e.held] < idx[e.acquired], (e.held, e.acquired)
    # the port's serve package has the reference's locks and edges
    ref = janalysis.analyze_locks()
    assert report.locks == ref.locks and report.rlocks == ref.rlocks
    assert ({(e.held, e.acquired) for e in report.edges}
            == {(e.held, e.acquired) for e in ref.edges})
    assert {a.path.rsplit("/", 1)[0] for a in report.accesses} == {"repro_torch/serve"}


_CYCLE_SRC = '''
import threading

class ShardedEmbeddingServer:
    def __init__(self):
        self._engine_lock = threading.RLock()
        self._stamp_lock = threading.Lock()

    def forward(self):
        with self._engine_lock:
            with self._stamp_lock:
                pass

    def backward(self):
        with self._stamp_lock:
            with self._engine_lock:  # reversed: deadlocks vs forward()
                pass
'''


def test_crafted_lock_order_cycle_detected():
    report = analyze_locks(sources={"crafted.py": _CYCLE_SRC})
    findings = report.findings()
    assert any("runs backwards against the blessed order" in f
               for f in findings), findings
    assert report.cycles, "reversed nesting must form a cycle"
    ref = janalysis.analyze_locks(sources={"crafted.py": _CYCLE_SRC})
    assert findings == ref.findings() and report.cycles == ref.cycles


_UNGUARDED_SRC = '''
import threading

class Engine:
    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def bump(self):
        with self._lock:
            self._count += 1

    def read(self):
        with self._lock:
            return self._count

    def racy_reset(self):
        self._count = 0
'''


def test_crafted_unguarded_write_detected():
    report = analyze_locks(sources={"crafted.py": _UNGUARDED_SRC})
    findings = report.findings()
    assert any("Engine._count" in f and "racy_reset" in f
               for f in findings), findings
    assert findings == janalysis.analyze_locks(
        sources={"crafted.py": _UNGUARDED_SRC}).findings()


def test_unlocked_marker_suppresses_documented_access():
    src = _UNGUARDED_SRC.replace(
        "    def racy_reset(self):\n        self._count = 0",
        "    def racy_reset(self):\n"
        "        self._count = 0  # unlocked: single-threaded teardown",
    )
    assert analyze_locks(sources={"crafted.py": src}).findings() == []
    assert janalysis.analyze_locks(sources={"crafted.py": src}).findings() == []


def test_lock_monitor_enforce_raises_on_backwards_acquisition():
    graph = OrderGraph()
    stamp = LockMonitor(BLESSED_LOCK_ORDER[2], threading.Lock(), graph,
                        enforce=True)
    engine = LockMonitor(BLESSED_LOCK_ORDER[0], threading.RLock(), graph,
                         enforce=True)
    with engine:
        with stamp:  # forward: engine -> stamp is blessed
            pass
    with stamp:
        with pytest.raises(LockOrderError):
            with engine:  # backwards: stamp -> engine
                pass
    assert graph.edge_set() == {(BLESSED_LOCK_ORDER[0], BLESSED_LOCK_ORDER[2])}


def test_runtime_monitor_agrees_with_static_graph_under_stress():
    static = {(e.held, e.acquired) for e in analyze_locks().edges}
    srv = _server(threaded=True)
    graph = monitor_server(srv, enforce=True)
    try:
        streams = [
            list(zipf_queries(ROWS, 24, 5.0, seed=100 + p))
            for p in range(3)
        ]
        errs = []

        def body(idx):
            try:
                for i, q in enumerate(streams[idx]):
                    srv.submit("a" if i % 2 == 0 else "b", q,
                               producer=f"p{idx}")
            except Exception as e:  # pragma: no cover - surfaced below
                errs.append(e)

        threads = [threading.Thread(target=body, args=(i,), daemon=True)
                   for i in range(len(streams))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        srv.drain()
        assert not errs
    finally:
        srv.close()
    # every observed acquisition ran forward in the blessed order...
    assert graph.check_blessed() == []
    assert graph.cycles() == []
    assert graph.edge_set(), "stress must exercise nested acquisitions"
    # ...and is one the static over-approximation knows (so never the
    # reverse of a static edge, which would be a deadlock pair)
    assert graph.edge_set() <= static, graph.edge_set() - static


def test_report_closed_flag_is_locked_snapshot():
    # report() reads ``_closed`` through the stamp lock that guards every
    # write to it (_snapshot_closed), as the reference does
    srv = _server(threaded=False)
    try:
        assert srv.report()["scheduler"]["closed"] is False
    finally:
        srv.close()
    assert srv.report()["scheduler"]["closed"] is True


def test_flush_holds_engine_lock_against_concurrent_submit():
    # a user-called flush() walks ``_buffer`` under the engine lock, so a
    # concurrent global-mode submit() is never dropped or double-served
    srv = _server(threaded=False, flush_policy="global")
    try:
        rng = np.random.default_rng(7)
        stop = threading.Event()
        errs = []

        def flusher():
            try:
                while not stop.is_set():
                    srv.flush()
            except Exception as e:  # pragma: no cover - surfaced below
                errs.append(e)

        t = threading.Thread(target=flusher, daemon=True)
        t.start()
        for _ in range(32):
            srv.submit("a", rng.integers(0, ROWS, size=4))
        stop.set()
        t.join(timeout=60)
        assert not t.is_alive()
        srv.flush()
        assert not errs
        assert srv.stats.queries == 32
    finally:
        srv.close()


# --------------------------------------------------------------- lint --


def test_repo_lint_runs_clean():
    assert [str(f) for f in run_lint()] == []


def test_lint_catches_each_crafted_violation(tmp_path):
    port = tmp_path / "src" / "repro_torch"
    (port / "serve").mkdir(parents=True)
    (port / "mod_rand.py").write_text(
        "import numpy as np\n"
        "def f():\n"
        "    return np.random.rand(3)\n"
    )
    (port / "mod_pack.py").write_text(
        "def g(a, b, n):\n"
        "    key = a * n + b\n"
        "    return key\n"
    )
    (port / "serve" / "decode.py").write_text(
        "import time\n"
        "def merge_order():\n"
        "    return time.time()\n"
    )
    (port / "mod_mut.py").write_text(
        "def h(patch):\n"
        "    patch.promoted.append(1)\n"
    )
    (port / "mod_oracle.py").write_text(
        "def _reference_unused():\n"
        "    return 0\n"
    )
    (tmp_path / "tests").mkdir()
    (tmp_path / "tests" / "test_none.py").write_text("def test_ok(): pass\n")

    findings = run_lint(tmp_path)
    assert {f.rule for f in findings} == {
        "unseeded-random", "packed-key-guard", "wall-clock",
        "patch-mutation", "oracle-coverage", "docstring-coverage"}
    # every finding sits in the port's tree
    assert all(f.path.startswith("src/repro_torch/") for f in findings)


_TORCH_DRAWS = (
    "torch.rand(3)", "torch.randn(3)", "torch.randint(0, 5, (3,))",
    "torch.randperm(5)", "torch.normal(0.0, 1.0, (3,))",
    "torch.bernoulli(x)", "torch.multinomial(x, 1)", "x.normal_()",
    "x.uniform_()", "x.random_(0, 5)", "x.bernoulli_(0.5)",
    "x.exponential_()",
)


@pytest.mark.parametrize("draw", _TORCH_DRAWS)
def test_lint_catches_torch_global_generator_draws(tmp_path, draw):
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    bench = tmp_path / "benchmarks"
    bench.mkdir()
    body = "def f(x, gen):\n    return {}\n"
    # the port's modules, the smoke and a port bench are all in scope; a
    # reference bench (no repro_torch import) is the reference's lint's
    (tmp_path / "src" / "repro_torch" / "mod.py").write_text(
        "import torch\n" + body.format(draw))
    (tmp_path / "chip_smoke.py").write_text(body.format(draw))
    (bench / "torch_bench.py").write_text(
        "import torch as th\nimport repro_torch\n"
        + body.format(draw.replace("torch.", "th.")))
    (bench / "ref_bench.py").write_text("import torch\n" + body.format(draw))
    found = run_lint(tmp_path)
    assert [(f.rule, f.path) for f in found] == [
        ("unseeded-random", "benchmarks/torch_bench.py"),
        ("unseeded-random", "chip_smoke.py"),
        ("unseeded-random", "src/repro_torch/mod.py"),
    ], found
    # with an explicit generator the same draw is clean
    seeded = draw[:-1] + (", " if draw[-2] != "(" else "") + "generator=gen)"
    for path in ((tmp_path / "src" / "repro_torch" / "mod.py"),
                 (tmp_path / "chip_smoke.py")):
        path.write_text("import torch\n" + body.format(seeded))
    (bench / "torch_bench.py").write_text(
        "import repro_torch\n" + body.format(seeded))
    assert run_lint(tmp_path) == []


def test_lint_packed_key_guard_accepts_guarded_module(tmp_path):
    port = tmp_path / "src" / "repro_torch"
    port.mkdir(parents=True)
    (port / "mod_ok.py").write_text(
        "def _check_pair_key_capacity(n):\n"
        "    if n * n >= 1 << 63:\n"
        "        raise OverflowError(n)\n"
        "def g(a, b, n):\n"
        "    _check_pair_key_capacity(n)\n"
        "    key = a * n + b\n"
        "    return key\n"
    )
    assert run_lint(tmp_path) == []
