"""Offline pipeline parity: ``repro_torch``'s NumPy copies against ``repro``.

Same seeded traces through both packages; every array must be
bit-identical (graph frequencies and edges, grouping, replication plan,
layout, shard plan).
"""

import dataclasses

import numpy as np
import pytest

import repro.core as jcore
import repro.data as jdata
import repro.dist as jdist
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.dist as tdist


def assert_same(a, b, path="root"):
    """Recursive field-by-field equality of dataclasses, arrays and lists."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype, f"{path}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


TRACES = {
    "zipf": lambda pkg: pkg.zipf_queries(2048, 512, 12.0, seed=3),
    "scale": lambda pkg: pkg.scale_trace(4096, 1024, 16.0, seed=5),
}


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_traces_identical(trace):
    a, b = TRACES[trace](jdata), TRACES[trace](tdata)
    assert len(a) == len(b)
    for qa, qb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(qa), np.asarray(qb))


def _plan(pkg_core, pkg_dist, rows, hist, epoch, group_size=64, batch=256):
    graph = pkg_core.build_cooccurrence(hist, rows)
    grouping = pkg_core.correlation_aware_grouping(graph, group_size, epoch=epoch)
    rplan = pkg_core.plan_replication(grouping, graph.freq, batch)
    layout = pkg_core.build_layout(grouping, rplan, 128)
    gfreq = grouping.group_freq(graph.freq)
    shards = [
        pkg_dist.plan_shards([layout], [rplan], s, group_freqs=[gfreq])
        for s in (1, 2, 4)
    ]
    return graph, grouping, rplan, layout, gfreq, shards


@pytest.mark.parametrize("trace,rows", [("zipf", 2048), ("scale", 4096)])
@pytest.mark.parametrize("epoch", [1, 64])
def test_offline_pipeline_bit_identical(trace, rows, epoch):
    hist = TRACES[trace](jdata)
    ref = _plan(jcore, jdist, rows, hist, epoch)
    port = _plan(tcore, tdist, rows, hist, epoch)
    for name, a, b in zip(
        ("graph", "grouping", "replication", "layout", "group_freq", "shards"),
        ref, port,
    ):
        assert_same(a, b, name)
    for a, b in zip(ref[-1], port[-1]):
        assert a.memory_summary() == b.memory_summary()


def test_fused_image_and_shard_images_identical():
    rng = np.random.default_rng(0)
    hists = [jdata.zipf_queries(512, 128, 8.0, seed=s) for s in (1, 2)]
    tables = [rng.normal(size=(512, 128)).astype(np.float32) for _ in hists]
    ref = [_plan(jcore, jdist, 512, h, 1, group_size=16) for h in hists]
    port = [_plan(tcore, tdist, 512, h, 1, group_size=16) for h in hists]
    fj = jdist.build_fused_image([r[3] for r in ref], tables)
    ft = tdist.build_fused_image([p[3] for p in port], tables)
    np.testing.assert_array_equal(fj, ft)
    sj = jdist.plan_shards([r[3] for r in ref], [r[2] for r in ref], 2,
                           group_freqs=[r[4] for r in ref])
    st = tdist.plan_shards([p[3] for p in port], [p[2] for p in port], 2,
                           group_freqs=[p[4] for p in port])
    assert_same(sj, st, "fused_plan")
    np.testing.assert_array_equal(sj.build_shard_images(fj), st.build_shard_images(ft))


def test_query_tile_bitmaps_identical():
    hist = jdata.zipf_queries(1024, 256, 10.0, seed=9)
    layout_j = _plan(jcore, jdist, 1024, hist, 1, group_size=32)[3]
    layout_t = _plan(tcore, tdist, 1024, hist, 1, group_size=32)[3]
    ev = jdata.zipf_queries(1024, 64, 10.0, seed=10)
    aj = jcore.query_tile_bitmaps(layout_j, ev)
    at = tcore.query_tile_bitmaps(layout_t, ev)
    assert_same(aj, at, "bitmaps")


# ---------------- cost model, dynamic switch, simulator and baselines --

# tests/test_core.py's traces: (rows, queries, mean bag, seed); the first
# half of each is the history, the second the simulated batch
SIM_TRACES = [(256, 64, 3.0, 3), (256, 256, 4.0, 4), (512, 256, 8.0, 5)]


@pytest.mark.parametrize("pipeline", ["recross", "naive", "frequency", "nmars"])
@pytest.mark.parametrize("trace", SIM_TRACES)
def test_baseline_pipelines_bit_identical(pipeline, trace):
    rows, n, bag, seed = trace
    qs = jdata.zipf_queries(rows, n, bag, seed=seed)
    hist, batch = qs[: n // 2], qs[n // 2:]
    out = []
    for core in (jcore, tcore):
        graph = core.build_cooccurrence(hist, rows)
        if pipeline == "recross":
            res = core.baselines.recross_pipeline(graph, batch, group_size=16, dim=8,
                                                  batch_size=len(batch))
        elif pipeline == "frequency":
            res = core.baselines.frequency_pipeline(graph, batch, group_size=16, dim=8)
        else:
            fn = getattr(core.baselines, f"{pipeline}_pipeline")
            res = fn(rows, batch, group_size=16, dim=8)
        out.append(res)
    assert_same(out[0][0], out[1][0], "layout")
    assert_same(out[0][1], out[1][1], "report")


@pytest.mark.parametrize("trace", SIM_TRACES)
@pytest.mark.parametrize("dynamic_switching,balance,threshold", [
    (True, True, 1), (False, True, 1), (True, False, 1), (False, False, 1),
    (True, True, 2), (True, True, 4),
])
def test_simulate_batch_equals_reference_and_jax(trace, dynamic_switching, balance,
                                                 threshold):
    from repro.core.simulator import _reference_simulate_batch as j_ref_sim
    from repro_torch.core.simulator import _reference_simulate_batch as t_ref_sim

    rows, n, bag, seed = trace
    qs = jdata.zipf_queries(rows, n, bag, seed=seed)
    hist, batch = qs[: n // 2], qs[n // 2:]
    layout = _plan(tcore, tdist, rows, hist, 1, group_size=16, batch=len(batch))[3]
    kw = dict(dynamic_switching=dynamic_switching, balance_replicas=balance,
              switch_threshold=threshold)
    port = tcore.simulate_batch(layout, batch, **kw)
    assert_same(port, t_ref_sim(layout, batch, **kw), "port vs its loop")
    assert_same(port, jcore.simulate_batch(layout, batch, **kw), "port vs jax")
    assert_same(port, j_ref_sim(layout, batch, **kw), "port vs jax loop")


def test_dynamic_switch_and_cost_model_identical():
    import torch

    counts = np.random.default_rng(0).integers(0, 9, size=(6, 40))
    for thr in (1, 2, 4):
        np.testing.assert_array_equal(tcore.select_mode(counts, threshold=thr),
                                      jcore.select_mode(counts, threshold=thr))
        got = tcore.torch_select_mode(torch.from_numpy(counts), threshold=thr)
        want = np.asarray(jcore.jnp_select_mode(counts, threshold=thr))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
        assert tcore.mode_statistics(counts, threshold=thr) == \
            jcore.mode_statistics(counts, threshold=thr)
    bits = (np.random.default_rng(1).random((5, 64)) < 0.1).astype(np.uint8)
    np.testing.assert_array_equal(tcore.popcount(bits), jcore.popcount(bits))
    assert tcore.energy_breakeven_rows() == jcore.energy_breakeven_rows()
    assert dataclasses.asdict(tcore.DEFAULT_RERAM) == dataclasses.asdict(jcore.DEFAULT_RERAM)
    for rows in (1, 2, 7, 64):
        assert tcore.DEFAULT_RERAM.crossbar_mac_event(rows) == \
            jcore.DEFAULT_RERAM.crossbar_mac_event(rows)
        assert tcore.DEFAULT_RERAM.crossbar_static_mac_event(rows) == \
            jcore.DEFAULT_RERAM.crossbar_static_mac_event(rows)
        assert tcore.DEFAULT_RERAM.cpu_reduction_event(rows) == \
            jcore.DEFAULT_RERAM.cpu_reduction_event(rows)
    assert tcore.DEFAULT_RERAM.crossbar_read_event() == \
        jcore.DEFAULT_RERAM.crossbar_read_event()
