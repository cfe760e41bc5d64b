"""Drift tracking of the port (``repro_torch.serve.drift`` and
``core.reduction.fused_group_loads``) on the CPU against ``repro``'s.

The tracker is host float64 arithmetic in both packages, so every step
must agree exactly; the per-group loads are exact counts, so the port's
must equal the reference's wherever the reference counts exactly (f32
bitmaps, and bf16 up to 256 active rows a tile), and the observation
memo must hit and miss on the same flushes.
"""

import numpy as np
import pytest
import torch

from repro.core import build_cooccurrence as jax_cooc
from repro.core import build_layout as jax_layout
from repro.core import compile_queries as jax_compile
from repro.core import correlation_aware_grouping as jax_grouping
from repro.core import fused_group_loads as jax_loads
from repro.core import plan_replication as jax_replication
from repro.core.reduction import CompiledQueries as JaxCompiled
from repro.data import zipf_queries
from repro.dist import plan_shards as jax_plan_shards
from repro.serve import LoadObservationCache as JaxCache
from repro.serve import ReplanConfig as JaxReplan
from repro.serve import ShardedEmbeddingServer as JaxServer
from repro.serve.drift import DriftTracker as JaxTracker
from repro_torch.convert import tables_from_numpy
from repro_torch.core import (
    CompiledQueries,
    build_cooccurrence,
    build_layout,
    compile_queries,
    correlation_aware_grouping,
    fused_group_loads,
    plan_replication,
)
from repro_torch.dist import plan_shards
from repro_torch.serve import (
    DriftTracker,
    LoadObservationCache,
    ReplanConfig,
    ShardedEmbeddingServer as TorchServer,
)

EQ1_BATCH = 64


def _int_table(rows, dim, seed):
    """Integer-valued f32 table: partial sums are exact in float32."""
    return np.random.default_rng(seed).integers(-8, 9, size=(rows, dim)).astype(np.float32)


def _pipelines(rows, hist, group_size=16, dim=128):
    """The same offline plan through both packages: (port, reference)
    layouts and two-shard plans."""
    out = []
    for cooc, grouping, replication, layout, plan in (
        (build_cooccurrence, correlation_aware_grouping, plan_replication,
         build_layout, plan_shards),
        (jax_cooc, jax_grouping, jax_replication, jax_layout, jax_plan_shards),
    ):
        g = cooc(hist, rows)
        grp = grouping(g, group_size)
        rp = replication(grp, g.freq, EQ1_BATCH)
        lay = layout(grp, rp, dim)
        sp = plan([lay], [rp], 2, group_freqs=[grp.group_freq(g.freq)])
        out.append((lay, sp))
    return out


# ------------------------------------------------------------ tracker --


def test_tracker_matches_reference_step_by_step():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 50, size=24).astype(np.float64)
    segments = [(0, 10), (10, 24)]
    port = DriftTracker(base, half_life=2.5, min_queries=20)
    ref = JaxTracker(base, half_life=2.5, min_queries=20)
    for step in range(12):
        loads = rng.integers(0, 9, size=24).astype(np.float64)
        # a hot-set rotation half-way: mass moves onto the second segment
        if step >= 6:
            loads[10:] *= 4
            loads[rng.random(24) < 0.5] = 0.0
        n = int(rng.integers(1, 8))
        port.observe(loads, n)
        ref.observe(loads, n)
        np.testing.assert_array_equal(port.load(), ref.load())
        assert port.ready == ref.ready
        assert port.observed_queries == ref.observed_queries
        assert port.observations == ref.observations
        np.testing.assert_array_equal(port.drifted_groups(), ref.drifted_groups())
        for seg in (None, segments):
            assert port.drift_from(base, seg) == ref.drift_from(base, seg)
        if step % 4 == 3:
            port.reset_drifted()
            ref.reset_drifted()
            marks = rng.choice(24, size=3, replace=False)
            port.mark_drifted(marks)
            ref.mark_drifted(marks)
            np.testing.assert_array_equal(port.drifted_groups(), ref.drifted_groups())
    assert port.ready and port.drift_from(base, segments) > 0.0
    with pytest.raises(ValueError, match="shape"):
        port.observe(np.zeros(3), 1)


def test_tracker_statistic():
    """The statistic scenario of ``tests/test_replan.py``."""
    base = np.array([8.0, 4.0, 2.0, 1.0])
    tr = DriftTracker(base, half_life=1.0, min_queries=4)
    assert not tr.ready and tr.drift_from(base) == 0.0
    tr.observe(base * 2, num_queries=4)
    assert tr.ready and abs(tr.drift_from(base)) < 1e-12
    for _ in range(12):
        tr.observe(np.array([0.0, 0.0, 0.0, 30.0]), num_queries=4)
    assert tr.drift_from(base) > 0.7
    assert tr.drift_from(np.zeros(4)) == 0.0


def test_replan_config_defaults_match_reference():
    assert ReplanConfig().__dict__ == JaxReplan().__dict__


# ------------------------------------------------- fused group loads --


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seed", [11, 12])
def test_fused_group_loads_match_reference(dtype, seed):
    rows = 160
    hist = zipf_queries(rows, 40, 5.0, seed=seed)
    (lay, sp), (jlay, jsp) = _pipelines(rows, hist)
    ev = zipf_queries(rows, 12, 5.0, seed=seed + 1)
    cq = compile_queries(lay, ev, replica_block=4, dtype=dtype, device="cpu")
    jcq = jax_compile(jlay, ev, replica_block=4)
    tile_group = np.repeat(np.arange(sp.num_groups), sp.group_copies)
    got = fused_group_loads(cq, tile_group, sp.num_groups)
    want = jax_loads(jcq, tile_group, jsp.num_groups)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the per-row semantics: a query touching k rows of a group counts k
    rowsem = np.zeros(sp.num_groups)
    for q in ev:
        np.add.at(rowsem, lay.group_of[np.unique(np.asarray(q, np.int64))], 1.0)
    np.testing.assert_array_equal(got, rowsem)


def test_fused_group_loads_of_an_empty_batch():
    cq = CompiledQueries(
        tile_ids=torch.full((4, 2), -1, dtype=torch.int32),
        bitmaps=torch.zeros((4, 2, 16)), max_tiles=2,
    )
    np.testing.assert_array_equal(fused_group_loads(cq, np.zeros(3, np.int64), 3), np.zeros(3))


def test_bf16_popcount_is_exact_above_256_rows():
    """A deliberate difference: at ``tile_rows = 512`` a bf16 slot with
    more than 256 active rows is counted exactly here, where the
    reference's bf16 sum stops at 256."""
    tile_rows, active = 512, 300
    bms = np.zeros((2, 1, tile_rows), dtype=np.float32)
    bms[0, 0, :active] = 1.0
    bms[1, 0, :7] = 1.0
    ids = np.array([[0], [1]], dtype=np.int32)
    tile_group = np.array([0, 1], dtype=np.int64)
    cq = CompiledQueries(tile_ids=torch.from_numpy(ids),
                         bitmaps=torch.from_numpy(bms).to(torch.bfloat16), max_tiles=1)
    np.testing.assert_array_equal(fused_group_loads(cq, tile_group, 2), [active, 7.0])
    import jax.numpy as jnp

    ref = jax_loads(JaxCompiled(tile_ids=ids, bitmaps=jnp.asarray(bms, jnp.bfloat16),
                                max_tiles=1), tile_group, 2)
    assert ref[0] == 256.0 and ref[1] == 7.0


# ------------------------------------------------ observation memo --


def test_observation_cache_counts_match_reference():
    rows = 192
    hist = zipf_queries(rows, 48, 6.0, seed=2)
    (lay, sp), (jlay, _) = _pipelines(rows, hist)
    tile_group = np.repeat(np.arange(sp.num_groups), sp.group_copies)
    port, ref = LoadObservationCache(maxsize=4), JaxCache(maxsize=4)
    # repeats inside and beyond the LRU bound
    for seed in (3, 3, 4, 5, 3, 6, 7, 8, 9, 3, 9):
        ev = zipf_queries(rows, 8, 6.0, seed=seed)
        got = port.loads(compile_queries(lay, ev, replica_block=4, device="cpu"),
                         tile_group, sp.num_groups)
        want = ref.loads(jax_compile(jlay, ev, replica_block=4),
                         tile_group, sp.num_groups)
        np.testing.assert_array_equal(got, want)
        assert (port.hits, port.misses) == (ref.hits, ref.misses)
    assert port.hits >= 2 and len(port._memo) <= 4


def test_observation_key_reads_bf16_bytes():
    """The digest hashes 16-bit bitmaps through their bytes (no NumPy
    view of bf16 exists): equal content hits, one flipped bit misses."""
    ids = torch.tensor([[0, 1]], dtype=torch.int32)
    bms = torch.zeros((1, 2, 16), dtype=torch.bfloat16)
    bms[0, 0, 3] = 1
    a = CompiledQueries(ids, bms, 2)
    b = CompiledQueries(ids.clone(), bms.clone(), 2)
    c_bms = bms.clone()
    c_bms[0, 1, 0] = 1
    c = CompiledQueries(ids, c_bms, 2)
    f32 = CompiledQueries(ids, bms.float(), 2)
    key = LoadObservationCache._key
    assert key(a) == key(b)
    assert key(a) != key(c) and key(a) != key(f32)


def test_server_memoizes_repeated_flush_observation():
    """``tests/test_tiers.py``'s memo scenario, both servers."""
    rows, dim = 256, 128
    tables = {"a": _int_table(rows, dim, 41)}
    histories = {"a": zipf_queries(rows, 48, 5.0, seed=42)}
    kw = dict(num_shards=2, q_block=4, group_size=16, batch_size=8)
    cfg = dict(threshold=0.9, half_life=4, min_queries=10**9)
    ref = JaxServer(tables, histories, replan=JaxReplan(**cfg), **kw)
    port = TorchServer(tables_from_numpy(tables, "cpu"), histories, device="cpu",
                       replan=ReplanConfig(**cfg), **kw)
    batch = [list(range(5 * i, 5 * i + 5)) for i in range(8)]
    for _ in range(3):
        np.testing.assert_array_equal(np.asarray(ref.serve({"a": batch})["a"]),
                                      port.serve({"a": batch})["a"].numpy())
    assert port.stats.load_obs_misses == ref.stats.load_obs_misses == 1
    assert port.stats.load_obs_hits == ref.stats.load_obs_hits == 2
    assert port.stats.summary()["tiers"] == ref.stats.summary()["tiers"]
