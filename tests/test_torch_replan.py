"""Online replanning of the port (``repro_torch.dist.replan``,
``kernels.sharded.patch_shard_images`` and the replan half of
``serve.ShardedEmbeddingServer``) on the CPU against ``repro``'s.

The plan patch is host NumPy in both packages and must be equal field
for field, to the reference's and to the retained ``_reference_*``
oracle; applied plans must hold equal arrays; patched images equal
bytes.  Integer-valued tables make every partial sum exact, so a server
with ``replan=`` must drain rows bit-identical to the reference server's
(``mesh=None``) under the same policy, stage the same patches and count
the same replans, rebases and patched tiles.  Mirrors
``tests/test_replan.py``, the patch-math scenarios of
``tests/test_scale_plan.py`` and ``tests/test_tiers.py``, and the patch
barrier scenarios of ``tests/test_scheduler.py`` and
``tests/test_multiproducer.py``.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dist as jdist
from repro.analysis.invariants import InvariantViolation as JaxViolation
from repro.core.cooccurrence import CoOccurrenceGraph as JaxGraph
from repro.data import zipf_queries
from repro.dist.replan import PagingPolicy as JaxPaging
from repro.dist.replan import _reference_compute_plan_patch as jax_oracle
from repro.dist.shard_plan import ShardPlan as JaxPlan
from repro.dist.shard_plan import TableSegment as JaxSegment
from repro.kernels import patch_shard_images as jax_patch_images
from repro.serve import ReplanConfig as JaxReplan
from repro.serve import ShardedEmbeddingServer as JaxServer
from repro_torch import core
from repro_torch.analysis.invariants import InvariantViolation
from repro_torch.convert import tables_from_numpy
from repro_torch.core.cooccurrence import CoOccurrenceGraph
from repro_torch.dist import (
    PagingPolicy,
    apply_plan_patch,
    build_fused_image,
    compute_plan_patch,
    plan_shards,
    rescale_load_to_plan,
)
from repro_torch.dist.replan import _reference_compute_plan_patch
from repro_torch.dist.shard_plan import COLD, ShardPlan, TableSegment
from repro_torch.kernels.sharded import crossbar_reduce_sharded, patch_shard_images
from repro_torch.serve import ReplanConfig, ShardedEmbeddingServer as TorchServer

EQ1_BATCH = 64
DIM = 128
PLAN_FIELDS = ("replicated_group", "shard_of_group", "shard_of_tile",
               "local_tile_of", "local_num_tiles", "group_load", "group_copies")
PATCH_FIELDS = ("promoted", "demoted", "dma", "freed", "new_capacity", "moved",
                "fetched", "evicted", "fetch_dma", "evicted_tiles", "deferred")
REPLAN_STATS = ("replans", "rebases", "patched_tiles", "promoted_groups",
                "demoted_groups", "barrier_flushes", "batches", "queries")


def _int_table(rows, seed, dim=DIM):
    """Integer-valued f32 table: partial sums are exact in float32."""
    return np.random.default_rng(seed).integers(-8, 9, size=(rows, dim)).astype(np.float32)


def _oracle(table, queries):
    """Host gather+sum over each query's distinct rows."""
    return np.stack([table[np.unique(np.asarray(q, np.int64))].sum(axis=0)
                     for q in queries])


def _assert_plans_equal(port, ref):
    assert port.num_shards == ref.num_shards
    assert port.capacity_tiles == ref.capacity_tiles
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)


def _assert_patches_equal(a, b):
    for f in PATCH_FIELDS:
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.drifted_load, b.drifted_load)
    assert a.summary() == b.summary() and a.is_noop() == b.is_noop()


class _Pipe:
    """One table's offline plan through both packages at once."""

    def __init__(self, rows, hist, num_shards, *, group_size=16, capacity_tiles=None,
                 seed=0):
        self.port, self.ref = {}, {}
        for pkg, out in ((core, self.port), (jcore, self.ref)):
            g = pkg.build_cooccurrence(hist, rows)
            grouping = pkg.correlation_aware_grouping(g, group_size)
            out["plan"] = pkg.plan_replication(grouping, g.freq, EQ1_BATCH)
            out["layout"] = pkg.build_layout(grouping, out["plan"], DIM)
            out["gfreq"] = grouping.group_freq(g.freq)
        self.table = _int_table(rows, seed)
        self.fused = build_fused_image([self.port["layout"]], [self.table])
        self.jfused = jdist.build_fused_image([self.ref["layout"]], [self.table])
        np.testing.assert_array_equal(self.fused, self.jfused)
        self.sp = self.plan(num_shards, capacity_tiles=capacity_tiles)
        self.jsp = self.plan(num_shards, capacity_tiles=capacity_tiles, ref=True)
        _assert_plans_equal(self.sp, self.jsp)

    def plan(self, num_shards, *, ref=False, freqs=None, **kw):
        side, fn = (self.ref, jdist.plan_shards) if ref else (self.port, plan_shards)
        return fn([side["layout"]], [side["plan"]], num_shards,
                  group_freqs=[side["gfreq"] if freqs is None else freqs], **kw)

    def serve(self, sp, images, queries):
        """The port's sharded reduction of ``queries`` through ``sp``."""
        cq = core.compile_queries(self.port["layout"], queries, replica_block=4, device="cpu")
        sbq = core.shard_block_queries(cq, sp, 4)
        out = crossbar_reduce_sharded(images, sbq.tile_ids, sbq.bitmaps, combine_chunks=2)
        return out[: sbq.batch].numpy()


def _patch_both(pipe, sp, jsp, load, **kw):
    """The patch in both packages (and the port's oracle), held equal."""
    patch = compute_plan_patch(sp, load, eq1_batch=EQ1_BATCH, **kw)
    jpatch = jdist.compute_plan_patch(jsp, load, eq1_batch=EQ1_BATCH, **kw)
    _assert_patches_equal(patch, jpatch)
    if kw.get("candidates") is None:
        kw.pop("candidates", None)
        _assert_patches_equal(patch, _reference_compute_plan_patch(
            sp, load, eq1_batch=EQ1_BATCH, **kw))
    return patch, jpatch


def _apply_both(pipe, sp, jsp, images, jimages, patch, jpatch):
    """Applies both patches; plans and images held equal (the port's
    image is patched in place, the reference's functionally)."""
    sp2, jsp2 = apply_plan_patch(sp, patch), jdist.apply_plan_patch(jsp, jpatch)
    _assert_plans_equal(sp2, jsp2)
    images2 = patch_shard_images(images, patch, pipe.fused)
    jimages2 = jax_patch_images(jnp.asarray(jimages), jpatch, pipe.jfused)
    np.testing.assert_array_equal(images2.numpy(), np.asarray(jimages2))
    return sp2, jsp2, images2, jimages2


def _assert_valid_partition(sp):
    """Every tile owned by exactly one shard or resident on all of them."""
    S = sp.num_shards
    for t in range(sp.num_tiles):
        holders = int((sp.local_tile_of[:, t] >= 0).sum())
        assert holders == (S if sp.shard_of_tile[t] < 0 else 1), t
    for s in range(S):
        slots = sp.local_tile_of[s][sp.local_tile_of[s] >= 0]
        assert len(set(slots.tolist())) == slots.size == sp.local_num_tiles[s]


# ------------------------------------------------ patch math ≡ JAX --


def _scale_setup(seed, num_rows=3000, S=3):
    """``tests/test_scale_plan.py``'s Zipf plan, through both packages."""
    ranks = np.random.default_rng(seed).permutation(num_rows).astype(np.float64) + 1.0
    freq = (1e6 / ranks ** 1.05).astype(np.int64) + 1
    out = []
    for pkg, Graph, plan_fn in ((core, CoOccurrenceGraph, plan_shards),
                                (jcore, JaxGraph, jdist.plan_shards)):
        g = Graph(num_rows=num_rows, freq=freq,
                  indptr=np.zeros(num_rows + 1, dtype=np.int64),
                  indices=np.empty(0, dtype=np.int64),
                  weights=np.empty(0, dtype=np.int64), num_queries=num_rows // 10)
        grouping = pkg.frequency_grouping(g, 16)
        plan = pkg.plan_replication(grouping, g.freq, EQ1_BATCH)
        layout = pkg.build_layout(grouping, plan, 8)
        gfreq = grouping.group_freq(g.freq)
        out.append((plan_fn([layout], [plan], S, group_freqs=[gfreq],
                            eq1_batch=EQ1_BATCH), gfreq))
    _assert_plans_equal(out[0][0], out[1][0])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_patch_matches_reference_and_oracle(seed):
    (sp, gfreq), (jsp, _) = _scale_setup(seed)
    repl = np.flatnonzero(sp.replicated_group)
    cold = np.argsort(gfreq, kind="stable")[:12]
    hot = repl[: min(12, repl.size)]
    drift = gfreq.astype(np.float64)
    drift[hot] *= 0.02
    drift[cold] += float(gfreq[hot].sum()) * 0.98 / max(cold.size, 1)
    for kw in ({}, {"shrink_slack": 1}, {"capacity": int(sp.max_local_tiles) + 4}):
        patch = compute_plan_patch(sp, drift, eq1_batch=EQ1_BATCH, **kw)
        _assert_patches_equal(patch, jdist.compute_plan_patch(
            jsp, drift, eq1_batch=EQ1_BATCH, **kw))
        _assert_patches_equal(patch, _reference_compute_plan_patch(
            sp, drift, eq1_batch=EQ1_BATCH, **kw))
        _assert_patches_equal(patch, jax_oracle(jsp, drift, eq1_batch=EQ1_BATCH, **kw))
        # mass-preserving drift: the candidates path is exact
        cand = compute_plan_patch(sp, drift, eq1_batch=EQ1_BATCH,
                                  candidates=np.union1d(cold, hot), **kw)
        _assert_patches_equal(cand, patch)
        _assert_plans_equal(apply_plan_patch(sp, patch),
                            jdist.apply_plan_patch(jsp, patch))


def test_patch_noop_with_empty_candidates():
    (sp, gfreq), (jsp, _) = _scale_setup(7)
    load = gfreq.astype(np.float64)
    empty = np.empty(0, dtype=np.int64)
    p = compute_plan_patch(sp, load, eq1_batch=EQ1_BATCH, candidates=empty)
    assert not p.promoted and not p.demoted and not p.dma and not p.freed
    _assert_patches_equal(p, jdist.compute_plan_patch(
        jsp, load, eq1_batch=EQ1_BATCH, candidates=empty))
    with pytest.raises(ValueError, match="out of range"):
        compute_plan_patch(sp, load, eq1_batch=EQ1_BATCH, candidates=np.array([-1]))
    with pytest.raises(ValueError, match="shape"):
        compute_plan_patch(sp, load[:-1], eq1_batch=EQ1_BATCH)


def _paging_pipe(seed=3):
    """``tests/test_tiers.py``'s paging scenario: a capped one-shard plan
    with exactly as many slots as it occupies, so a fetch must evict."""
    rows = 192
    pipe = _Pipe(rows, zipf_queries(rows, 48, 6.0, seed=seed), 1)
    cap = max(2, pipe.sp.max_local_tiles // 2)
    cap = int(pipe.plan(1, capacity_tiles=cap).local_num_tiles[0])
    sp, jsp = pipe.plan(1, capacity_tiles=cap), pipe.plan(1, capacity_tiles=cap, ref=True)
    _assert_plans_equal(sp, jsp)
    assert sp.cold_groups.size > 0 and int(sp.local_num_tiles[0]) == cap
    return pipe, sp, jsp


@pytest.mark.parametrize("hysteresis,bounded", [(2.0, False), (1.1, False), (1.1, True)])
def test_paging_patch_matches_reference(hysteresis, bounded):
    pipe, sp, jsp = _paging_pipe()
    resident = np.nonzero((sp.shard_of_group >= 0) & ~sp.replicated_group)[0]
    load = np.zeros(sp.num_groups)
    load[resident] = 2.0
    load[resident[0]] = 1.0
    load[np.asarray(sp.replicated_group)] = 50.0
    load[sp.cold_groups] = 3.0 * hysteresis
    max_fetch = None
    if bounded:
        # one tile a patch: the multi-tile cold groups cool off, since
        # the fetch loop stops at the first group past the bound
        load[sp.cold_groups[sp.group_copies[sp.cold_groups] > 1]] = 0.0
        max_fetch = 1
    kw = dict(paging=PagingPolicy(sp.capacity_tiles, hysteresis=hysteresis,
                                  max_fetch_tiles=max_fetch), shrink_slack=0)
    patch = compute_plan_patch(sp, load, eq1_batch=EQ1_BATCH, **kw)
    jkw = dict(kw, paging=JaxPaging(sp.capacity_tiles, hysteresis=hysteresis,
                                    max_fetch_tiles=max_fetch))
    _assert_patches_equal(patch, jdist.compute_plan_patch(jsp, load, eq1_batch=EQ1_BATCH, **jkw))
    _assert_patches_equal(patch, _reference_compute_plan_patch(sp, load, eq1_batch=EQ1_BATCH, **kw))
    assert patch.fetched and patch.evicted and patch.new_capacity == sp.capacity_tiles
    if max_fetch is not None:
        assert len(patch.fetch_dma) <= max_fetch
    sp2 = apply_plan_patch(sp, patch)
    _assert_plans_equal(sp2, jdist.apply_plan_patch(jsp, patch))
    assert all(sp2.shard_of_group[g] == COLD for g in patch.evicted)
    # the fetch writes land the master image's tiles in the fetched slots
    images = torch.from_numpy(sp.build_shard_images(pipe.fused))
    images2 = patch_shard_images(images.clone(), patch, pipe.fused)
    jimages2 = jax_patch_images(jnp.asarray(images.numpy()), patch, pipe.jfused)
    np.testing.assert_array_equal(images2.numpy(), np.asarray(jimages2))
    for s, slot, t in patch.fetch_dma:
        np.testing.assert_array_equal(images2[s, slot].numpy(), pipe.fused[t])


def test_rescaled_load_matches_reference():
    pipe = _Pipe(192, zipf_queries(192, 48, 6.0, seed=13), 2)
    tiny = pipe.sp.group_load[::-1] / 512.0
    totals = [pipe.sp.group_load.sum()]
    got = rescale_load_to_plan(tiny, pipe.sp, totals)
    np.testing.assert_array_equal(got, jdist.rescale_load_to_plan(tiny, pipe.jsp, totals))
    np.testing.assert_allclose(got, pipe.sp.group_load[::-1])
    full = compute_plan_patch(pipe.sp, pipe.sp.group_load[::-1].copy(), eq1_batch=EQ1_BATCH)
    rescaled = compute_plan_patch(pipe.sp, got, eq1_batch=EQ1_BATCH)
    assert (rescaled.promoted, rescaled.demoted) == (full.promoted, full.demoted)


def _hand_plan(Plan, Segment):
    """The hand-built plan of the demotion-target scenarios."""
    return Plan(
        num_shards=2, tables=[Segment("t0", 0, 0, 4, 5, 16)],
        replicated_group=np.array([True, False, False, False]),
        shard_of_group=np.array([-1, 0, 0, 1], dtype=np.int32),
        shard_of_tile=np.array([-1, 0, 0, 0, 1], dtype=np.int32),
        local_tile_of=np.array([[0, 1, 2, 3, -1], [0, -1, -1, -1, 1]], dtype=np.int32),
        local_num_tiles=np.array([4, 2], dtype=np.int64),
        group_load=np.array([30.0, 1.0, 1.0, 20.0]),
        group_copies=np.array([1, 2, 1, 1], dtype=np.int64),
    )


@pytest.mark.parametrize("g0_load,owner", [(0.0, 1), (5.0, 0)])
def test_demotion_target_matches_reference(g0_load, owner):
    """A cooled demotion lands on the least tile-loaded shard, a loaded
    one on the least loaded shard (``tests/test_replan.py``)."""
    sp, jsp = _hand_plan(ShardPlan, TableSegment), _hand_plan(JaxPlan, JaxSegment)
    load = np.array([g0_load, 1.0, 1.0, 20.0])
    patch = compute_plan_patch(sp, load, eq1_batch=2)
    _assert_patches_equal(patch, jdist.compute_plan_patch(jsp, load, eq1_batch=2))
    assert patch.promoted == [] and patch.demoted == [(0, owner)]
    sp2 = apply_plan_patch(sp, patch)
    _assert_plans_equal(sp2, jdist.apply_plan_patch(jsp, patch))
    _assert_valid_partition(sp2)


def test_apply_plan_patch_rejects_what_the_reference_rejects(monkeypatch):
    sp, jsp = _hand_plan(ShardPlan, TableSegment), _hand_plan(JaxPlan, JaxSegment)
    patch = compute_plan_patch(sp, np.array([0.0, 1.0, 1.0, 20.0]), eq1_batch=2)
    twice, jtwice = apply_plan_patch(sp, patch), jdist.apply_plan_patch(jsp, patch)
    # validated (RECROSS_VALIDATE=1): the patch is refused before the
    # apply, with the reference's message
    monkeypatch.setenv("RECROSS_VALIDATE", "1")
    with pytest.raises(InvariantViolation, match="not replicated") as port:
        apply_plan_patch(twice, patch)
    with pytest.raises(JaxViolation, match="not replicated") as ref:
        jdist.apply_plan_patch(jtwice, patch)
    assert str(port.value) == str(ref.value)
    # unvalidated: the apply's own check refuses it
    monkeypatch.setenv("RECROSS_VALIDATE", "0")
    with pytest.raises(ValueError, match="not replicated"):
        apply_plan_patch(twice, patch)
    with pytest.raises(ValueError, match="not replicated"):
        jdist.apply_plan_patch(jtwice, patch)
    with pytest.raises(ValueError, match="no group_copies"):
        compute_plan_patch(ShardPlan(**{**sp.__dict__, "group_copies": None}),
                           sp.group_load, eq1_batch=2)


# ------------------------------------------------ plans and images --


@pytest.mark.parametrize("seed,num_shards", [(0, 1), (17, 2), (41, 2), (93, 4)])
def test_patched_plan_serves_bit_identical_to_fresh_rebuild(seed, num_shards):
    rows = 192
    pipe = _Pipe(rows, zipf_queries(rows, 48, 6.0, seed=seed), num_shards, seed=seed)
    images = torch.from_numpy(pipe.sp.build_shard_images(pipe.fused))
    jimages = np.asarray(pipe.jsp.build_shard_images(pipe.jfused))
    dload = pipe.sp.group_load[::-1].copy()
    patch, jpatch = _patch_both(pipe, pipe.sp, pipe.jsp, dload,
                                capacity=int(images.shape[1]))
    sp2, _, images2, _ = _apply_both(pipe, pipe.sp, pipe.jsp, images, jimages, patch, jpatch)
    _assert_valid_partition(sp2)
    fresh = pipe.plan(num_shards, freqs=dload, eq1_batch=EQ1_BATCH)
    np.testing.assert_array_equal(sp2.replicated_group, fresh.replicated_group)
    want_dma = sum(int(pipe.sp.group_copies[g]) * (num_shards - 1) for g in patch.promoted)
    assert patch.num_moved_tiles == want_dma
    ev = zipf_queries(rows, 10 + seed % 7, 6.0, seed=seed + 1)
    out = pipe.serve(sp2, images2, ev)
    np.testing.assert_array_equal(
        out, pipe.serve(fresh, torch.from_numpy(fresh.build_shard_images(pipe.fused)), ev))
    np.testing.assert_array_equal(out, _oracle(pipe.table, ev))


def test_repeated_patches_stay_consistent():
    """Patch → drift → patch: slot reuse, growth and re-promotion keep
    the plans, images and numerics equal to the reference's."""
    rows, S = 192, 2
    pipe = _Pipe(rows, zipf_queries(rows, 48, 6.0, seed=3), S, seed=3)
    sp, jsp = pipe.sp, pipe.jsp
    images = torch.from_numpy(sp.build_shard_images(pipe.fused))
    jimages = np.asarray(jsp.build_shard_images(pipe.jfused))
    ev = zipf_queries(rows, 9, 6.0, seed=4)
    for dload in (sp.group_load[::-1].copy(), np.roll(sp.group_load, sp.num_groups // 3),
                  sp.group_load.copy()):
        patch, jpatch = _patch_both(pipe, sp, jsp, dload, capacity=int(images.shape[1]))
        sp, jsp, images, jimages = _apply_both(pipe, sp, jsp, images, jimages, patch, jpatch)
        _assert_valid_partition(sp)
        np.testing.assert_array_equal(pipe.serve(sp, images, ev), _oracle(pipe.table, ev))


def test_demotion_moves_no_tiles_and_noop_rebases():
    pipe = _Pipe(192, zipf_queries(192, 48, 6.0, seed=5), 2)
    sp = pipe.sp
    assert sp.replicated_group.any()
    flat = np.full(sp.num_groups, 1.0)
    patch, _ = _patch_both(pipe, sp, pipe.jsp, flat)
    assert not patch.promoted and patch.num_moved_tiles == 0
    assert len(patch.demoted) == int(sp.replicated_group.sum())
    # a demote-only patch leaves holes; a rebuilt stack scatters into them
    sp2 = apply_plan_patch(sp, patch)
    rebuilt = sp2.build_shard_images(pipe.fused)
    np.testing.assert_array_equal(
        rebuilt, jdist.apply_plan_patch(pipe.jsp, patch).build_shard_images(pipe.jfused))
    ev = zipf_queries(192, 9, 6.0, seed=8)
    np.testing.assert_array_equal(pipe.serve(sp2, torch.from_numpy(rebuilt), ev),
                                  _oracle(pipe.table, ev))
    wobble = sp.group_load * 1.5
    noop, _ = _patch_both(pipe, sp, pipe.jsp, wobble)
    assert noop.is_noop()
    sp3 = apply_plan_patch(sp, noop)
    np.testing.assert_array_equal(sp3.local_tile_of, sp.local_tile_of)
    np.testing.assert_array_equal(sp3.group_load, wobble)


def test_shrink_slack_and_relocations_match_reference():
    """Slack age-out: the stack compacts, relocated tiles are copied from
    the master image, and serving through the shrunk stack stays exact."""
    rows, S, slack = 192, 2, 8
    pipe = _Pipe(rows, zipf_queries(rows, 48, 6.0, seed=3), S, seed=3)
    base = pipe.sp.build_shard_images(pipe.fused)
    padded = np.concatenate([base, np.zeros((S, slack) + base.shape[2:], base.dtype)], axis=1)
    images, jimages = torch.from_numpy(padded.copy()), padded.copy()
    flat = np.full(pipe.sp.num_groups, 1.0)
    keep, _ = _patch_both(pipe, pipe.sp, pipe.jsp, flat, capacity=images.shape[1])
    assert keep.new_capacity == images.shape[1] and not keep.moved
    p1, jp1 = _patch_both(pipe, pipe.sp, pipe.jsp, flat, capacity=images.shape[1],
                          shrink_slack=2)
    assert p1.new_capacity < images.shape[1]
    sp, jsp, images, jimages = _apply_both(pipe, pipe.sp, pipe.jsp, images, jimages, p1, jp1)
    assert images.shape[1] == p1.new_capacity == int(sp.local_num_tiles.max()) + 2
    # class-unchanged wobble + shrink: relocations make it no rebase
    p2, jp2 = _patch_both(pipe, sp, jsp, flat * 1.5, capacity=images.shape[1],
                          shrink_slack=0)
    assert not p2.promoted and not p2.demoted
    assert p2.is_noop() == (not p2.moved)
    sp, jsp, images, _ = _apply_both(pipe, sp, jsp, images, jimages, p2, jp2)
    _assert_valid_partition(sp)
    ev = zipf_queries(rows, 9, 6.0, seed=4)
    np.testing.assert_array_equal(pipe.serve(sp, images, ev), _oracle(pipe.table, ev))


def _write_patch(capacity, writes=(), moved=()):
    from repro_torch.dist import PlanPatch

    return PlanPatch(promoted=[], demoted=[], dma=list(writes), freed=[],
                     new_capacity=capacity, drifted_load=np.zeros(1), moved=list(moved))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_patch_images_grow_shrink_and_in_place(dtype):
    """Grow returns a new zero-padded stack; an unchanged depth writes in
    place; shrink returns a contiguous stack that owns only the kept
    slots (the old storage is released, not viewed)."""
    fused = np.random.default_rng(0).integers(-8, 9, size=(6, 16, DIM)).astype(np.float32)
    images = torch.from_numpy(fused[[0, 1, 2, 3]].reshape(2, 2, 16, DIM).copy()).to(dtype)
    grown = patch_shard_images(images, _write_patch(5, [(0, 4, 5), (1, 2, 4)]), fused)
    assert grown.shape == (2, 5, 16, DIM) and grown.dtype == dtype
    assert grown.data_ptr() != images.data_ptr()
    want = np.zeros((2, 5, 16, DIM), np.float32)
    want[:, :2] = fused[[0, 1, 2, 3]].reshape(2, 2, 16, DIM)
    want[0, 4], want[1, 2] = fused[5], fused[4]
    np.testing.assert_array_equal(grown.float().numpy(), want)
    jgrown = jax_patch_images(jnp.asarray(images.float().numpy()),
                              _write_patch(5, [(0, 4, 5), (1, 2, 4)]),
                              fused)
    np.testing.assert_array_equal(grown.float().numpy(), np.asarray(jgrown))

    ptr = grown.data_ptr()
    same = patch_shard_images(grown, _write_patch(5, [(1, 3, 0)]), fused)
    assert same is grown and same.data_ptr() == ptr
    np.testing.assert_array_equal(same[1, 3].float().numpy(), fused[0])

    shrunk = patch_shard_images(same, _write_patch(3, moved=[(0, 5, 4, 2)]), fused)
    assert shrunk.shape == (2, 3, 16, DIM) and shrunk.is_contiguous()
    assert all(shrunk[s].is_contiguous() for s in range(2))
    assert shrunk.untyped_storage().nbytes() == shrunk.numel() * shrunk.element_size()
    assert shrunk.data_ptr() != ptr
    np.testing.assert_array_equal(shrunk[0, 2].float().numpy(), fused[5])
    np.testing.assert_array_equal(shrunk[1].float().numpy(), want[1, :3])
    # a one-shard slice is already contiguous: shrink still copies it
    one = patch_shard_images(images[:1].clone(), _write_patch(1), fused)
    assert one.untyped_storage().nbytes() == one.numel() * one.element_size()


# ----------------------------------------------------- the server --


def _drift_stream(rows, n, *, seed=23, perm_seed=24, head=16):
    stream = zipf_queries(rows, n, 5.0, seed=seed)
    perm = np.random.default_rng(perm_seed).permutation(rows)
    return stream[:head] + [perm[np.asarray(q, np.int64)].tolist() for q in stream[head:]]


def _servers(tables, histories, *, replan, **kw):
    ref = JaxServer(tables, histories, replan=JaxReplan(**replan), **kw)
    port = TorchServer(tables_from_numpy(tables, "cpu"), histories, device="cpu",
                       replan=ReplanConfig(**replan), **kw)
    return ref, port


def _run(server, stream, name="a"):
    """Submits the stream, collects every row (submit returns + the final
    flush), closes; returns the rows as float32 NumPy."""
    parts = []
    for q in stream:
        out = server.submit(name, q)
        if out:
            parts.append(out[name])
    out = server.flush()
    if out:
        parts.append(out[name])
    server.close()
    return np.concatenate([
        p.float().numpy() if isinstance(p, torch.Tensor) else np.asarray(p) for p in parts
    ])


def _assert_servers_equal(ref, port):
    _assert_plans_equal(port.plan, ref.plan)
    np.testing.assert_array_equal(port.shard_images.numpy(), np.asarray(ref.shard_images))
    rs, ps = ref.stats.summary(), port.stats.summary()
    for key in REPLAN_STATS:
        assert rs[key] == ps[key], key
    assert rs["tiers"] == ps["tiers"]
    assert ref.report()["replan"] == port.report()["replan"]


POLICIES = [("global", False), ("per-shard", False), ("deadline", False),
            ("owner-set", False), ("owner-set", True)]


@pytest.mark.parametrize("num_shards", [2, 4])
@pytest.mark.parametrize("policy,threaded", POLICIES)
def test_server_replans_like_reference(policy, threaded, num_shards):
    """``tests/test_replan.py``'s drifting server under every policy: the
    same patches, plans, images and counts, rows bit for bit."""
    rows = 128
    tables = {"a": _int_table(rows, 21)}
    histories = {"a": zipf_queries(rows, 48, 5.0, seed=22)}
    kw = dict(num_shards=num_shards, q_block=4, group_size=16, batch_size=8,
              batch_size_for_eq1=512, flush_policy=policy)
    if threaded:
        kw["threaded"] = True
    ref, port = _servers(tables, histories, replan=dict(
        threshold=0.15, half_life=1.0, min_queries=8, slack_tiles=4), **kw)
    stream = _drift_stream(rows, 48)
    got = _run(port, stream)
    np.testing.assert_array_equal(got, _run(ref, stream))
    np.testing.assert_array_equal(got, _oracle(tables["a"], stream))
    _assert_servers_equal(ref, port)
    assert port.stats.replans >= 1 and port.stats.patched_tiles >= 1


def test_server_without_replan_keeps_no_master_image():
    tables = {"a": _int_table(128, 21)}
    histories = {"a": zipf_queries(128, 48, 5.0, seed=22)}
    kw = dict(num_shards=2, q_block=4, group_size=16, batch_size=8, device="cpu")
    plain = TorchServer(tables_from_numpy(tables, "cpu"), histories, **kw)
    assert plain._fused is None and plain.tracker is None
    assert "replan" not in plain.report()
    replan = TorchServer(tables_from_numpy(tables, "cpu"), histories,
                         replan=ReplanConfig(slack_tiles=3), **kw)
    assert replan._fused is not None
    assert replan.shard_images.shape[1] == plain.shard_images.shape[1] + 3


def test_bf16_server_tile_bytes_and_rows():
    """A bf16 image's tile bytes are the reference's bf16 tile bytes, and
    integer values below 2**8 serve the f32 server's rows exactly."""
    import ml_dtypes

    rows = 128
    tables = {"a": _int_table(rows, 21)}
    histories = {"a": zipf_queries(rows, 48, 5.0, seed=22)}
    kw = dict(num_shards=2, q_block=4, group_size=16, batch_size=8, batch_size_for_eq1=512)
    cfg = dict(threshold=0.15, half_life=1.0, min_queries=8, slack_tiles=4)
    ref = JaxServer({"a": tables["a"].astype(ml_dtypes.bfloat16)}, histories,
                    replan=JaxReplan(**cfg), **kw)
    port = TorchServer({"a": torch.from_numpy(tables["a"]).to(torch.bfloat16)}, histories,
                       device="cpu", replan=ReplanConfig(**cfg), **kw)
    assert port._tile_bytes == ref._tile_bytes == 16 * DIM * 2
    stream = _drift_stream(rows, 48)
    got = _run(port, stream)
    assert port.shard_images.dtype == torch.bfloat16
    np.testing.assert_array_equal(got, _oracle(tables["a"], stream))
    assert port.stats.replans >= 1


def test_server_windows_without_drift_apply_no_patch():
    """Replaying the training history patches nothing, and an idle table
    registers no drift (``tests/test_replan.py``)."""
    rows = 128
    tables = {"a": _int_table(rows, 31), "b": _int_table(rows, 32)}
    histories = {"a": zipf_queries(rows, 48, 5.0, seed=33),
                 "b": zipf_queries(rows, 48, 5.0, seed=34)}
    ref, port = _servers(tables, histories, num_shards=2, q_block=4, group_size=16,
                         batch_size=8, replan=dict(threshold=0.2, half_life=1.0, min_queries=8))
    for server in (ref, port):
        for q in histories["a"][:32]:
            server.submit("a", q)
        server.flush()
    _assert_servers_equal(ref, port)
    rep = port.report()
    assert rep["serve"]["replans"] == rep["serve"]["rebases"] == 0
    assert rep["replan"]["staged"] is None and rep["replan"]["drift"] < 0.2


def test_server_report_and_first_serve_match_reference():
    rows = 128
    tables = {"a": _int_table(rows, 21)}
    histories = {"a": zipf_queries(rows, 48, 5.0, seed=22)}
    ref, port = _servers(tables, histories, num_shards=2, q_block=4, group_size=16,
                         batch_size=8, replan=dict(threshold=0.2, half_life=1.0,
                                                   min_queries=8, slack_tiles=4))
    assert ref.report()["replan"] == port.report()["replan"]
    rep = port.report()["replan"]
    assert rep["drift"] == 0.0 and rep["ready"] is False and rep["staged"] is None
    ev = zipf_queries(rows, 4, 5.0, seed=30)
    np.testing.assert_array_equal(np.asarray(ref.serve({"a": ev})["a"]),
                                  port.serve({"a": ev})["a"].numpy())
    assert port.report()["replan"]["observed_queries"] == 4
    assert ref.report()["replan"] == port.report()["replan"]


def test_server_shrink_streak_reclaims_image_capacity():
    """The demotion-streak trigger compacts the stack back to working
    set + slack, through the sync ``serve`` path, like the reference."""
    rows = 320
    tables = {"a": _int_table(rows, 21)}
    histories = {"a": zipf_queries(rows, 64, 5.0, seed=22)}
    ref, port = _servers(tables, histories, num_shards=2, q_block=4, group_size=16,
                         batch_size=8, replan=dict(threshold=0.2, half_life=2.0,
                                                   min_queries=8, slack_tiles=4,
                                                   shrink_streak=1))
    assert port.plan.replicated_group.any()
    cap_before = int(port.shard_images.shape[1])
    ref._demote_streak = port._demote_streak = 1
    rng = np.random.default_rng(99)
    stream = [rng.choice(rows, size=24, replace=False).tolist() for _ in range(48)]
    for chunk in range(0, len(stream), 8):
        batch = {"a": stream[chunk: chunk + 8]}
        np.testing.assert_array_equal(np.asarray(ref.serve(batch)["a"]),
                                      port.serve(batch)["a"].numpy())
    _assert_servers_equal(ref, port)
    assert port.stats.replans >= 1 and port.stats.promoted_groups == 0
    assert int(port.shard_images.shape[1]) < cap_before
    assert port.report()["replan"]["slack_slots"] <= 4


# ------------------------------------------ patches at async barriers --


def _spied(server):
    """Records the in-flight depth at every patch application."""
    seen = []
    orig = server._apply_staged_patch

    def spy():
        if server._staged is not None:
            seen.append(len(server._in_flight))
        orig()

    server._apply_staged_patch = spy
    return seen


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_patch_staged_mid_pipeline_applies_at_barrier_only(num_shards):
    """``tests/test_scheduler.py``'s barrier scenario: a patch staged with
    flushes in flight waits for the barrier, in both servers alike."""
    rows = 128
    tables = {"a": _int_table(rows, 31)}
    histories = {"a": zipf_queries(rows, 48, 5.0, seed=32)}
    ref, port = _servers(tables, histories, num_shards=num_shards, q_block=4,
                         group_size=16, batch_size=8, batch_size_for_eq1=512,
                         flush_policy="per-shard", max_in_flight=4,
                         replan=dict(threshold=0.15, half_life=1.0, min_queries=8,
                                     slack_tiles=8))
    seen = _spied(port)
    stream = _drift_stream(rows, 48, seed=33, perm_seed=34)
    mid = False
    for q in stream:
        port.submit("a", q)
        ref.submit("a", q)
        mid |= port._staged is not None and bool(port._in_flight)
    out = port.drain()["a"].numpy()
    np.testing.assert_array_equal(out, np.asarray(ref.drain()["a"]))
    np.testing.assert_array_equal(out, _oracle(tables["a"], stream))
    assert mid and seen and all(n == 0 for n in seen)
    assert port.stats.barrier_flushes >= 1
    _assert_servers_equal(ref, port)


def test_patch_applies_at_barrier_only_under_thread_driver():
    rows = 128
    tables = {"a": _int_table(rows, 31)}
    histories = {"a": zipf_queries(rows, 48, 5.0, seed=32)}
    port = TorchServer(tables_from_numpy(tables, "cpu"), histories, device="cpu",
                       num_shards=2, q_block=4, group_size=16, batch_size=8,
                       batch_size_for_eq1=512, flush_policy="per-shard",
                       max_in_flight=4, threaded=True,
                       replan=ReplanConfig(threshold=0.15, half_life=1.0,
                                           min_queries=8, slack_tiles=8))
    seen = _spied(port)
    stream = _drift_stream(rows, 48, seed=33, perm_seed=34)
    for q in stream:
        port.submit("a", q)
    out = port.drain()["a"].numpy()
    port.close()
    assert seen and all(n == 0 for n in seen)
    assert port.stats.replans + port.stats.rebases >= 1
    np.testing.assert_array_equal(out, _oracle(tables["a"], stream))


def test_sync_serve_barriers_pending_async_queries():
    """A sync ``serve`` on an async server flushes pending queries under
    their plan before a staged patch applies; both servers alike."""
    rows = 128
    tables = {"a": _int_table(rows, 31)}
    histories = {"a": zipf_queries(rows, 48, 5.0, seed=32)}
    ref, port = _servers(tables, histories, num_shards=2, q_block=4, group_size=16,
                         batch_size=8, batch_size_for_eq1=512, flush_policy="per-shard",
                         max_in_flight=4, replan=dict(threshold=0.15, half_life=1.0,
                                                      min_queries=8, slack_tiles=8))
    stream = _drift_stream(rows, 44, seed=33, perm_seed=34)
    probe = zipf_queries(rows, 5, 5.0, seed=36)
    for i, q in enumerate(stream):
        port.submit("a", q)
        ref.submit("a", q)
        if i == len(stream) - 3:
            got = port.serve({"a": probe})["a"].numpy()
            np.testing.assert_array_equal(got, np.asarray(ref.serve({"a": probe})["a"]))
            np.testing.assert_array_equal(got, _oracle(tables["a"], probe))
    out = port.drain()["a"].numpy()
    np.testing.assert_array_equal(out, np.asarray(ref.drain()["a"]))
    np.testing.assert_array_equal(out, _oracle(tables["a"], stream))
    assert port.stats.replans >= 1
    _assert_servers_equal(ref, port)


def test_patched_async_server_matches_fresh_rebuild():
    """After the async replay's patches, the live plan serves a probe
    bit-identically to a fresh ``plan_shards`` on its load snapshot."""
    rows, S = 128, 2
    hist = zipf_queries(rows, 48, 5.0, seed=32)
    pipe = _Pipe(rows, hist, S, seed=31)
    tables = {"a": pipe.table}
    ref, port = _servers(tables, {"a": hist}, num_shards=S, q_block=4, group_size=16,
                         batch_size=8, flush_policy="per-shard",
                         replan=dict(threshold=0.2, half_life=1.0, min_queries=8,
                                     slack_tiles=4))
    stream = _drift_stream(rows, 48, seed=33, perm_seed=34)
    for q in stream:
        port.submit("a", q)
        ref.submit("a", q)
    port.drain()
    ref.drain()
    _assert_servers_equal(ref, port)
    assert port.stats.replans >= 1
    fresh = pipe.plan(S, freqs=port.plan.group_load, eq1_batch=port._eq1_batch)
    np.testing.assert_array_equal(port.plan.replicated_group, fresh.replicated_group)
    probe = zipf_queries(rows, 11, 5.0, seed=35)
    got = port.serve({"a": probe})["a"].numpy()
    np.testing.assert_array_equal(
        got, pipe.serve(fresh, torch.from_numpy(fresh.build_shard_images(pipe.fused)), probe))
    np.testing.assert_array_equal(got, np.asarray(ref.serve({"a": probe})["a"]))


def test_patch_applies_at_fifo_barrier_under_concurrent_producers():
    """``tests/test_multiproducer.py``'s patch barrier: four producers on
    the thread driver; every patch applies with the pipeline empty and
    every producer's drained stream stays exact."""
    rows, n_prod = 320, 4
    tables = {"a": _int_table(rows, 11)}
    histories = {"a": zipf_queries(rows, 48, 5.0, seed=13)}
    perm = np.random.default_rng(34).permutation(rows)
    streams = [list(zipf_queries(rows, 24, 5.0, seed=300 + p)) for p in range(n_prod)]
    streams = [s[:8] + [perm[np.asarray(q, np.int64)].tolist() for q in s[8:]]
               for s in streams]
    port = TorchServer(tables_from_numpy(tables, "cpu"), histories, device="cpu",
                       num_shards=2, q_block=4, group_size=16, batch_size=8,
                       batch_size_for_eq1=512, flush_policy="per-shard",
                       max_in_flight=4, threaded=True,
                       replan=ReplanConfig(threshold=0.15, half_life=1.0,
                                           min_queries=8, slack_tiles=8))
    seen = _spied(port)
    labels = [f"p{i}" for i in range(n_prod)]
    for lab in labels:
        port.register_producer(lab)
    errs = []

    def body(i):
        try:
            for q in streams[i]:
                port.submit("a", q, producer=labels[i])
        except Exception as e:  # re-raised below
            errs.append(e)

    threads = [threading.Thread(target=body, args=(i,), daemon=True) for i in range(n_prod)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive(), "producer thread wedged"
    assert not errs, errs
    outs = {lab: port.drain(producer=lab) for lab in labels}
    port.close()
    assert seen and all(n == 0 for n in seen)
    assert port.stats.barrier_flushes >= 1
    for lab, stream in zip(labels, streams):
        np.testing.assert_array_equal(outs[lab]["a"].numpy(), _oracle(tables["a"], stream))
