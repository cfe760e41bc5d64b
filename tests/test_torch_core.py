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
