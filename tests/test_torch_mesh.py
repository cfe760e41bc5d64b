"""The multi-process combine of the port (``mesh=``, one gloo rank per
shard on the CPU) against both packages' single-device emulation.

Mirrors the reference's ``shard_map`` tests (``tests/test_sharded_serving.
py``, ``tests/test_scheduler.py``, ``tests/test_replan.py``), which fail
here on the installed jax: the reference's mesh path cannot be run, so
the port's mesh path is held against ``repro``'s ``mesh=None`` path,
which the reference tests pin to its ``shard_map`` path, and against the
port's own emulation and a host gather+sum.  Each world (2, 3 and 4
ranks, module-scoped, ``tests/_torch_mesh_worlds.py``) runs all its cases
in one spawn; every case is a test of its own.  Integer-valued tables
make every partial sum exact, so rows must be bit-identical; random f32
tables are held at atol 1e-5 and bf16 at atol 0.15 / rtol 1e-2
(``tests/test_kernels.py``).  A 3-rank world covers ``dim % S != 0``,
which the kernel's ``dim % 128 == 0`` rules out for 2 and 4 shards.
"""

import concurrent.futures
import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_worlds as W
from repro.core import compile_queries as j_compile_queries
from repro.core import shard_block_queries as j_shard_block_queries
from repro.dist import build_fused_image as j_build_fused_image
from repro.dist import plan_shards as j_plan_shards
from repro.core import (build_cooccurrence as j_cooc, build_layout as j_layout,
                        correlation_aware_grouping as j_grouping,
                        plan_replication as j_replication)
from repro.dist import compute_plan_patch as j_compute_plan_patch
from repro.kernels import crossbar_reduce_sharded as j_reduce_sharded
from repro.kernels import patch_shard_images as j_patch_images
from repro.launch import serve_sharded as jax_launch
from repro.serve import ReplanConfig as JaxReplan
from repro.serve import ShardedEmbeddingServer as JaxServer
from repro.serve.tiers import TierConfig as JaxTiers
from repro_torch.convert import tables_from_numpy
from repro_torch.core import compile_queries, shard_block_queries
from repro_torch.dist import apply_plan_patch, build_fused_image, compute_plan_patch
from repro_torch.dist.mesh import MeshError, ShardMesh, init_shard_mesh
from repro_torch.kernels.sharded import (
    combine_route,
    crossbar_reduce_sharded,
    dispatch_cache_stats,
    patch_shard_images,
    result_bytes,
)
from repro_torch.serve import ShardedEmbeddingServer
from repro_torch.serve.sharded import serve_worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMBINES = ("psum_scatter", "psum")
CHUNKS = (1, 2)
# participants per world size: the full stack, a divisible subset with
# and without rank 0, a non-divisible subset without rank 0 (3 of 4)
# and a single participant that is not rank 0
PARTS = {
    2: ([0, 1], [1]),
    3: ([0, 1, 2], [1, 2]),
    4: ([0, 1, 2, 3], [1, 3], [0, 2], [1, 2, 3], [2]),
}
REDUCE = [(S, parts, combine, chunks) for S in PARTS for parts in PARTS[S]
          for combine in COMBINES for chunks in CHUNKS]
RANDOM = {"float32": dict(parts=[0, 1, 2, 3], combine="psum_scatter", chunks=2),
          "bfloat16": dict(parts=[1, 3], combine="psum", chunks=2)}
SERVER_KW = {"q_block": 4, "group_size": 16, "batch_size": 8}
FAIL_TIMEOUT_S = 10.0


def _reduce_name(S, parts, combine, chunks):
    return f"S{S}-{'_'.join(map(str, parts))}-{combine}-c{chunks}"


# ------------------------------------------------------------ streams --


def _drifted(rows, n, seed, cut, tables=("a",)):
    """``n`` Zipf queries a table, interleaved round robin, row ids of the
    tail from ``cut`` on rotated through one permutation."""
    streams = W.server_stream(rows, n, seed, tables=tables)
    perm = np.random.default_rng(4).permutation(rows)
    out = []
    for i in range(n):
        for t in tables:
            q = np.asarray(streams[t][i], np.int64)
            out.append((t, (perm[q] if i >= cut else q).tolist()))
    return out


def _owner_stream():
    """The reference's owner-set mesh test stream: Zipf queries, then
    queries over two shards' rows (``tests/test_scheduler.py``)."""
    tabs, hists = W.server_setup(4)
    probe = ShardedEmbeddingServer(tables_from_numpy(tabs, "cpu"), hists, num_shards=4,
                                   device="cpu", flush_policy="owner-set", **SERVER_KW)
    owner = probe.scheduler._owner_of_row["a"]
    by_owner = {}
    for r, o in enumerate(owner):
        if o >= 0:
            by_owner.setdefault(int(o), []).append(r)
    a, b = sorted(by_owner)[:2]
    stream = [("a", list(q)) for q in W.server_stream(96, 18, 2)["a"]]
    stream += [("a", [by_owner[a][i % len(by_owner[a])], by_owner[b][i % len(by_owner[b])]])
               for i in range(10)]
    return stream


def _server_cases():
    """``{world size: [(name, setup, stream, producers, kwargs), ...]}``."""
    plain = [("a", list(q)) for q in W.server_stream(96, 30, 2)["a"]]
    drift = _drifted(96, 30, 2, 10)
    replan = dict(threshold=0.2, half_life=1.0, min_queries=8, slack_tiles=4)
    two = {"rows": 320, "tables": ("a", "b"), "seed": 11}
    return {
        2: [
            ("global", {}, plain, 0, {}),
            ("per-shard-replan", {}, drift, 0, {"flush_policy": "per-shard", "replan": replan}),
            ("global-replan", {}, drift, 0, {"replan": replan}),
            ("tiers", two, _drifted(320, 40, 5, 20, tables=("a", "b")), 0,
             {"flush_policy": "per-shard", "batch_size": 16,
              "tiers": {"capacity_frac": 0.5},
              "replan": dict(threshold=0.2, half_life=4, min_queries=32)}),
        ],
        4: [
            ("global", {}, plain, 0, {}),
            ("owner-set-threaded-producers", {}, _owner_stream(), 2,
             {"flush_policy": "owner-set", "threaded": True}),
        ],
    }


SERVER_CASES = _server_cases()
SERVER_IDS = [(S, c[0]) for S in SERVER_CASES for c in SERVER_CASES[S]]


# ------------------------------------------------------------- worlds --


def _world_cases(S):
    cases = [(_reduce_name(S, parts, combine, chunks), "reduce",
              dict(parts=parts, combine=combine, chunks=chunks))
             for S_, parts, combine, chunks in REDUCE if S_ == S]
    if S == 4:
        cases += [(f"random-{dt}", "reduce", dict(table="normal", dtype=dt, **kw))
                  for dt, kw in RANDOM.items()]
    if S in (2, 4):
        cases.append(("patch", "patch", {}))
    for name, setup, stream, producers, kw in SERVER_CASES.get(S, ()):
        cases.append((f"server-{name}", "server",
                      dict(setup=setup, stream=stream, producers=producers,
                           **SERVER_KW | kw)))
    return cases


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """``world(S)``: rank 0's results of the ``S``-rank world; the worlds
    run once, side by side."""
    base = tmp_path_factory.mktemp("mesh")
    sizes = sorted(PARTS)
    with concurrent.futures.ThreadPoolExecutor(len(sizes)) as pool:
        runs = {S: pool.submit(W.run_world, S, _world_cases(S), str(base / f"w{S}"))
                for S in sizes}
        results = {S: run.result() for S, run in runs.items()}
    return results.__getitem__


def _result(world, S, name):
    status, value = world(S)[name]
    assert status == "ok", value
    return value


# ----------------------------------------------------------- oracles --


def _oracle(table, queries):
    """Host gather+sum over each query's distinct rows."""
    return np.stack([table[np.unique(np.asarray(q, np.int64))].sum(axis=0)
                     for q in queries])


@functools.cache
def _emulated(S, parts, table="int", dtype="float32"):
    """Both packages' ``mesh=None`` reduction of one case's batch, and the
    gather+sum of the logical table."""
    parts = list(parts)
    tab, hist, queries = W.kernel_inputs(S, parts, table=table)
    images, sbq = W.port_stack(tab, hist, queries, S, parts, dtype=dtype)
    port = crossbar_reduce_sharded(images, sbq.tile_ids, sbq.bitmaps, shard_ids=parts)
    g = j_cooc(hist, tab.shape[0])
    grouping = j_grouping(g, 16)
    rep = j_replication(grouping, g.freq, 64)
    layout = j_layout(grouping, rep, tab.shape[1])
    plan = j_plan_shards([layout], [rep], S, group_freqs=[grouping.group_freq(g.freq)])
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    cq = j_compile_queries(layout, queries, replica_block=4, dtype=jdt)
    jsbq = j_shard_block_queries(cq, plan, 4, participants=parts)
    jimg = jnp.asarray(plan.build_shard_images(j_build_fused_image([layout], [tab])), jdt)
    ref = j_reduce_sharded(jimg, jsbq.tile_ids, jsbq.bitmaps, shard_ids=parts)
    n = len(queries)
    return (port.float().numpy()[:n], np.asarray(ref, np.float32)[:n],
            _oracle(tab, queries))


# ------------------------------------------------- the reduction itself --


@pytest.mark.parametrize("S,parts,combine,chunks", REDUCE,
                         ids=[_reduce_name(*c) for c in REDUCE])
def test_mesh_reduce_matches_both_emulations(world, S, parts, combine, chunks):
    """Every branch on integer-valued tables: bit-identical to both
    packages' emulation and to gather+sum, on rank 0 whether or not it
    participates."""
    got = _result(world, S, _reduce_name(S, parts, combine, chunks))
    port, ref, oracle = _emulated(S, tuple(parts))
    np.testing.assert_array_equal(got["out"], port)
    np.testing.assert_array_equal(got["out"], ref)
    np.testing.assert_array_equal(got["out"], oracle)
    assert got["route"] == combine_route(S, parts, 128, combine)


@pytest.mark.parametrize("dtype", list(RANDOM))
def test_mesh_reduce_random_tables_within_tolerance(world, dtype):
    kw = RANDOM[dtype]
    got = _result(world, 4, f"random-{dtype}")["out"]
    port, ref, oracle = _emulated(4, tuple(kw["parts"]), "normal", dtype)
    tol = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=0.15, rtol=1e-2)}[dtype]
    np.testing.assert_allclose(got, port, **tol)
    np.testing.assert_allclose(got, ref, **tol)
    if dtype == "float32":
        np.testing.assert_allclose(got, oracle, **tol)


def test_mesh_routes_cover_every_branch_and_cache_subgroups(world):
    """The worlds ran every branch of the reference; the subset cases
    created each participants' subgroup once and reused it after."""
    routes = {_result(world, S, _reduce_name(S, p, c, k))["route"]
              for S, p, c, k in REDUCE}
    assert routes == {"single", "subset", "scatter", "psum"}
    # the 4-rank world's last subset case: [0, 2] after [1, 3], 4 calls each
    stats = _result(world, 4, _reduce_name(4, [0, 2], "psum", 2))["subgroups"]
    assert stats["misses"] == 2 and stats["hits"] == 6, stats


@pytest.mark.parametrize("S", [2, 4])
def test_mesh_patch_writes_each_rank_its_own_shard(world, S):
    """The SPMD plan patch: every rank's shard equals the emulated
    stack's, which equals the reference's, after the reference's
    reversed-load patch and a grow and a shrink; the batch over the
    patched plan is bit-identical to the emulation and gather+sum."""
    got = _result(world, S, "patch")
    assert got["writes"] > 0
    tab, hist, queries = W.kernel_inputs(S, list(range(S)))
    plan, layout = W._plan(tab, hist, S)
    fused = build_fused_image([layout], [tab])
    stack = torch.from_numpy(plan.build_shard_images(fused))
    patch = compute_plan_patch(plan, plan.group_load[::-1].copy(), eq1_batch=32)
    want = patch_shard_images(stack.clone(), patch, fused)
    cq = compile_queries(layout, queries, replica_block=4, device="cpu")
    sbq = shard_block_queries(cq, apply_plan_patch(plan, patch), 4)
    out = crossbar_reduce_sharded(want, sbq.tile_ids, sbq.bitmaps, combine_chunks=2)
    np.testing.assert_array_equal(got["out"], out.numpy()[: sbq.batch])
    np.testing.assert_array_equal(got["out"], _oracle(tab, queries))
    g = j_cooc(hist, tab.shape[0])
    grouping = j_grouping(g, 16)
    rep = j_replication(grouping, g.freq, 64)
    jlayout = j_layout(grouping, rep, tab.shape[1])
    jplan = j_plan_shards([jlayout], [rep], S, group_freqs=[grouping.group_freq(g.freq)])
    jpatch = j_compute_plan_patch(jplan, jplan.group_load[::-1].copy(), eq1_batch=32)
    jwant = j_patch_images(jnp.asarray(stack.numpy()), jpatch, j_build_fused_image([jlayout], [tab]))
    np.testing.assert_array_equal(want.numpy(), np.asarray(jwant))
    for extra in W.synthetic_patches(S, want.shape[1]):
        want = patch_shard_images(want, extra, fused)
    np.testing.assert_array_equal(got["images"], want.numpy())


def test_combine_route_and_result_bytes_follow_the_reference_rule():
    assert combine_route(4, [2], 128, "psum_scatter") == "single"
    assert combine_route(4, [1, 3], 128, "psum_scatter") == "subset"
    assert combine_route(4, [1, 2, 3], 128, "psum_scatter") == "scatter"
    assert combine_route(4, [1, 2, 3], 128, "psum") == "psum"
    assert combine_route(3, [0, 1, 2], 128, "psum_scatter") == "psum"
    assert combine_route(1, [0], 128, "psum_scatter") == "single"
    assert result_bytes(4, [1, 3], 16, 128, "psum", 4) == 16 * 128 * 4
    assert result_bytes(4, [0, 2], 16, 128, "psum", 2) == 0
    assert result_bytes(4, [1, 2, 3], 16, 128, "psum", 4) == 0
    assert result_bytes(4, [2], 8, 128, "psum_scatter", 2) == 8 * 128 * 2


def _fake_mesh(rank=0, size=2):
    return ShardMesh(rank=rank, size=size, device=torch.device("cpu"), backend="gloo",
                     ctrl=None)


def test_mesh_arguments_are_validated_like_the_reference():
    img = torch.zeros(1, 4, 16, 128)
    ids = torch.full((1, 1, 2), -1, dtype=torch.int32)
    bms = torch.zeros(1, 1, 2, 4, 16)
    mesh = _fake_mesh()
    with pytest.raises(ValueError, match="mesh axis 'data' has size 1, need 2 shards"):
        crossbar_reduce_sharded(img, ids, bms, mesh=mesh, axis_name="data")
    with pytest.raises(ValueError, match="unknown combine 'sum'"):
        crossbar_reduce_sharded(img, ids, bms, mesh=mesh, combine="sum")
    with pytest.raises(ValueError, match="its own shard"):
        crossbar_reduce_sharded(torch.zeros(2, 4, 16, 128), ids, bms, mesh=mesh)
    with pytest.raises(ValueError, match="out of range for 2 shards"):
        crossbar_reduce_sharded(img, ids, bms, mesh=mesh, shard_ids=[2])
    with pytest.raises(TypeError, match="ShardMesh"):
        crossbar_reduce_sharded(img, ids, bms, mesh=object())
    with pytest.raises(ValueError, match="rank 0 runs"):
        serve_worker(mesh)
    with pytest.raises(ValueError, match="one per shard"):
        init_shard_mesh(4, rank=0, world_size=2, device="cpu")
    tabs, hists = W.server_setup(2)
    for bad, match in ((_fake_mesh(rank=1), "runs serve_worker"),
                       (_fake_mesh(size=4), "mesh of 4 ranks for 2 shards")):
        with pytest.raises(ValueError, match=match):
            ShardedEmbeddingServer(tables_from_numpy(tabs, "cpu"), hists, num_shards=2,
                                   mesh=bad, device="cpu")


def test_dispatch_cache_stats_reports_the_subgroup_cache():
    zero = dispatch_cache_stats()
    assert zero["mesh_subset"] == {"hits": 0, "misses": 0, "currsize": 0, "maxsize": 0}
    mesh = _fake_mesh()
    mesh._hits, mesh._misses = 3, 2
    stats = dispatch_cache_stats(mesh)
    assert stats["mesh_subset"] == {"hits": 3, "misses": 2, "currsize": 0, "maxsize": 64}
    assert stats["total"] == {"hits": 3, "misses": 2, "maxsize": 64}


# --------------------------------------------------------- the server --


def _merge_order(stream, producers):
    """Positions of ``stream`` per table in a full drain's ``(local_seq,
    producer)`` merge order."""
    if not producers:
        order = {}
        for i, (t, _) in enumerate(stream):
            order.setdefault(t, []).append(i)
        return order
    local, keyed = {}, {}
    for i, (t, _) in enumerate(stream):
        p = i % producers
        seq = local.get((p, t), 0)
        local[(p, t)] = seq + 1
        keyed.setdefault(t, []).append((seq, p, i))
    return {t: [i for _, _, i in sorted(v)] for t, v in keyed.items()}


@functools.cache
def _emulated_servers(S, name):
    """The port's and the reference's emulated servers over one server
    case: rows and stats summaries."""
    setup, stream, producers, kw = next(c[1:] for c in SERVER_CASES[S] if c[0] == name)
    tabs, hists = W.server_setup(S, **setup)
    kw = SERVER_KW | kw
    port = ShardedEmbeddingServer(
        tables_from_numpy(tabs, "cpu"), hists, num_shards=S, device="cpu",
        **W._server_kwargs(kw))
    jkw = dict(kw)
    if "replan" in jkw:
        jkw["replan"] = JaxReplan(**jkw["replan"])
    if "tiers" in jkw:
        jkw["tiers"] = JaxTiers(**jkw["tiers"])
    ref = JaxServer(tabs, hists, num_shards=S, mesh=None, **jkw)
    out = []
    for server in (port, ref):
        try:
            rows = W.drive(server, stream, producers)
        finally:
            server.close()
        out.append((rows, server.stats.summary()))
    return out, tabs, stream, producers


@pytest.mark.parametrize("S,name", SERVER_IDS, ids=[f"S{S}-{n}" for S, n in SERVER_IDS])
def test_mesh_server_matches_emulated_servers(world, S, name):
    """The mesh server (rank 0 controller, gloo workers) drains rows
    bit-identical to the port's and the reference's emulated servers and
    to gather+sum, reports ``shard_map`` and holds only its own shard;
    inline, its flush accounting (``combine_bytes`` included) equals the
    reference's."""
    got = _result(world, S, f"server-{name}")
    emulated, tabs, stream, producers = _emulated_servers(S, name)
    (port_rows, port_st), (ref_rows, ref_st) = emulated
    order = _merge_order(stream, producers)
    assert sorted(got["rows"]) == sorted(ref_rows) == sorted(port_rows)
    for t, rows in got["rows"].items():
        np.testing.assert_array_equal(rows, port_rows[t])
        np.testing.assert_array_equal(rows, ref_rows[t])
        np.testing.assert_array_equal(rows, _oracle(tabs[t], [stream[i][1] for i in order[t]]))
    st, rep = got["summary"], got["report"]
    assert rep["mode"] == "shard_map" and rep["mesh"]["ranks"] == S
    assert got["image_shape"][0] == 1
    assert sum(len(r) for r in got["rows"].values()) == len(stream)
    assert st["queries"] == ref_st["queries"]
    assert set(st) == set(ref_st)
    if not producers:
        for key in ("batches", "shard_flushes", "participant_sizes", "combine_bytes",
                    "replans", "rebases", "patched_tiles", "tiers"):
            assert st[key] == ref_st[key] == port_st[key], key


def test_mesh_server_runs_the_subset_combine_and_drift(world):
    owner = _result(world, 4, "server-owner-set-threaded-producers")
    sizes = {int(k) for k in owner["summary"]["participant_sizes"]}
    assert 2 in sizes, sizes
    assert owner["report"]["dispatch_cache"]["mesh_subset"]["misses"] >= 1
    assert owner["report"]["scheduler"]["threaded"] is True
    for name in ("per-shard-replan", "global-replan"):
        st = _result(world, 2, f"server-{name}")["summary"]
        assert st["replans"] >= 1 and st["patched_tiles"] > 0, st
    tiers = _result(world, 2, "server-tiers")["summary"]["tiers"]
    assert tiers["host_queries"] > 0 and tiers["hot_queries"] > 0, tiers


def test_mesh_combine_bytes_follow_the_reference_accounting(world):
    """The global flushes of the 4-rank world: every flush combines the
    full axis, so the bytes are the reference's ring formula per batch."""
    got = _result(world, 4, "server-global")["summary"]
    assert got["participant_sizes"] == {"4": got["batches"]}
    ref = _emulated_servers(4, "global")[0][1][1]
    assert got["combine_bytes"] == ref["combine_bytes"] > 0


def test_worker_failure_raises_on_rank_zero_without_hanging(tmp_path):
    """A worker whose kernel raises loses the world: rank 0's flush raises
    MeshError well within the group timeout, and nothing retries it."""
    stream = [("a", list(q)) for q in W.server_stream(96, 12, 2)["a"]]
    out = W.run_world(2, [("fail", "worker_failure",
                           dict(setup={}, stream=stream, **SERVER_KW))],
                      tmp_path, timeout_s=FAIL_TIMEOUT_S, wait_s=4 * FAIL_TIMEOUT_S)
    status, got = out["fail"]
    assert status == "ok", got
    assert got["error"] is not None and got["error"][0] == MeshError.__name__, got
    assert got["seconds"] < FAIL_TIMEOUT_S + 5.0, got
    assert got["mode"]["workers"] == "lost", got


# ------------------------------------------------------------ launcher --


LAUNCH = ["--shards", "2", "--tables", "2", "--rows", "512", "--history", "512",
          "--requests", "192", "--batch-size", "32"]


@pytest.mark.parametrize("extra", [
    ["--capacity-frac", "0.5", "--drift", "--flush-policy", "deadline"],
    ["--inject", "compile:1,poison:1", "--watchdog", "1.0", "--flush-policy", "per-shard"],
])
def test_launcher_mesh_run_matches_reference_emulate(extra, capsys):
    """A 2-rank gloo run of the port's launcher against the reference
    launcher's ``--emulate`` report: the same ``serve`` counters and
    ``tiers`` / ``faults`` blocks (``tests/test_torch_tiers.py`` holds the
    port's ``--emulate`` run to the same report)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_sharded", "--device", "cpu",
         "--backend", "gloo"] + LAUNCH + extra,
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    mesh = json.loads(proc.stdout)
    jax_launch.main(jax_launch.parse_args(["--emulate"] + LAUNCH + extra))
    ref = json.loads(capsys.readouterr().out)
    assert mesh["mode"] == "shard_map" and ref["mode"] == "emulated"
    assert mesh["mesh"]["ranks"] == 2 and mesh["mesh"]["backend"] == "gloo"
    keys = ("queries", "batches", "shard_flushes", "participant_sizes", "combine_bytes",
            "replans", "rebases", "patched_tiles", "tiers")
    for key in keys:
        assert mesh["serve"][key] == ref["serve"][key], key
    for block, flag in (("tiers", "--capacity-frac"), ("faults", "--inject")):
        assert (block in mesh) == (block in ref) == (flag in extra)
        if block in ref:
            assert set(mesh[block]) == set(ref[block])
    if "tiers" in ref:
        assert mesh["tiers"] == ref["tiers"]
    if "faults" in ref:
        assert mesh["faults"]["plan"] == ref["faults"]["plan"]
        assert mesh["faults"]["injected"] == ref["faults"]["injected"]
        q = [row[:2] for row in mesh["serve"]["faults"]["quarantined"]]
        assert q == [row[:2] for row in ref["serve"]["faults"]["quarantined"]]
