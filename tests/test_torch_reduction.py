"""Query-compile and reduction parity: ``repro_torch.core.reduction``
against ``repro.core.reduction`` on the same seeded queries.

Compiled schedules must equal the reference's field by field (bitmaps in
the same dtype), and the torch reductions must match the JAX ones.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.dist as jdist
from repro.core import reduction as jred
from repro.data import zipf_queries
import repro_torch.core as tcore
import repro_torch.dist as tdist
from repro_torch.core import reduction as tred

F32_TOL = 1e-5


def _np(x):
    """Tensor or jax array → NumPy (bf16 widened to float32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def assert_same_compile(ref, port):
    """Field-by-field equality of two compiled batches."""
    assert type(ref).__name__ == type(port).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if isinstance(b, torch.Tensor):
            assert b.device.type == "cpu"
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=f.name)
            assert str(np.asarray(a).dtype).replace("bfloat16", "bf16") == {
                torch.float32: "float32", torch.bfloat16: "bf16",
                torch.int32: "int32",
            }[b.dtype], f.name
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def _layouts(rows=512, group_size=16, seed=0):
    hist = zipf_queries(rows, 128, 8.0, seed=seed)
    out = []
    for core in (jcore, tcore):
        g = core.build_cooccurrence(hist, rows)
        grouping = core.correlation_aware_grouping(g, group_size)
        plan = core.plan_replication(grouping, g.freq, 64)
        out.append((core.build_layout(grouping, plan, 128), plan,
                    grouping.group_freq(g.freq)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("replica_block", [1, 4])
def test_compile_queries_identical(dtype, replica_block):
    (lj, _, _), (lt, _, _) = _layouts()
    ev = zipf_queries(512, 37, 8.0, seed=1)
    ref = jred.compile_queries(lj, ev, dtype=getattr(jnp, dtype),
                               replica_block=replica_block)
    port = tred.compile_queries(lt, ev, dtype=getattr(torch, dtype),
                                replica_block=replica_block, device="cpu")
    assert_same_compile(ref, port)


@pytest.mark.parametrize("q_block", [1, 4, 8])
@pytest.mark.parametrize("batch", [16, 21])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_compiled_queries_identical(q_block, batch, dtype):
    (lj, _, _), (lt, _, _) = _layouts(seed=q_block)
    ev = zipf_queries(512, batch, 8.0, seed=batch)
    cj = jred.compile_queries(lj, ev, replica_block=q_block, dtype=getattr(jnp, dtype))
    ct = tred.compile_queries(lt, ev, replica_block=q_block,
                              dtype=getattr(torch, dtype), device="cpu")
    assert_same_compile(jred.block_compiled_queries(cj, q_block),
                        tred.block_compiled_queries(ct, q_block))


def _two_table_setup(num_shards, q_block=4):
    """Two tables offset into one fused tile space, compiled by both."""
    (lj0, pj0, gj0), (lt0, pt0, gt0) = _layouts(seed=3)
    (lj1, pj1, gj1), (lt1, pt1, gt1) = _layouts(seed=4)
    spj = jdist.plan_shards([lj0, lj1], [pj0, pj1], num_shards, group_freqs=[gj0, gj1])
    spt = tdist.plan_shards([lt0, lt1], [pt0, pt1], num_shards, group_freqs=[gt0, gt1])
    evs = [zipf_queries(512, n, 8.0, seed=40 + n) for n in (13, 22)]
    fused = []
    for red, layouts, sp, kw in (
        (jred, (lj0, lj1), spj, {}),
        (tred, (lt0, lt1), spt, {"device": "cpu"}),
    ):
        cqs = [
            red.offset_compiled_queries(
                red.compile_queries(lay, ev, replica_block=q_block, **kw),
                seg.tile_offset,
            )
            for lay, ev, seg in zip(layouts, evs, sp.tables)
        ]
        fused.append((red.concat_compiled_queries(cqs, q_block), cqs, sp))
    return fused


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_offset_concat_and_shard_block_identical(num_shards):
    q_block = 4
    (fj, cqs_j, spj), (ft, cqs_t, spt) = _two_table_setup(num_shards, q_block)
    for a, b in zip(cqs_j, cqs_t):
        assert_same_compile(a, b)
    (cj, spans_j), (ct, spans_t) = fj, ft
    assert spans_j == spans_t
    assert_same_compile(cj, ct)
    assert_same_compile(jred.shard_block_queries(cj, spj, q_block),
                        tred.shard_block_queries(ct, spt, q_block))


@pytest.mark.parametrize("participants", [[0], [2, 1], [0, 1, 2, 3]])
def test_shard_block_participants_identical(participants):
    q_block = 4
    (fj, _, spj), (ft, _, spt) = _two_table_setup(4, q_block)
    cj, ct = fj[0], ft[0]

    def run(red, cq, sp):
        try:
            return red.shard_block_queries(cq, sp, q_block, participants=participants)
        except ValueError as e:  # a subset that misses an owner must raise in both
            return str(e)

    a, b = run(jred, cj, spj), run(tred, ct, spt)
    if isinstance(a, str):
        assert a == b
    else:
        assert_same_compile(a, b)
        np.testing.assert_array_equal(a.shard_ids, b.shard_ids)


def test_block_key_capacity_raises_in_both():
    for red in (jred, tred):
        red._check_block_key_capacity(10, 10, "ok")
        with pytest.raises(OverflowError):
            red._check_block_key_capacity(1 << 40, 1 << 40, "boom")


@pytest.mark.parametrize("dynamic_switch", [True, False])
def test_reduce_via_layout_and_oracle_match(dynamic_switch):
    (lj, _, _), (lt, _, _) = _layouts(seed=6)
    table = np.random.default_rng(6).normal(size=(512, 128)).astype(np.float32)
    ev = zipf_queries(512, 24, 8.0, seed=7) + [[5, 5, 9]]
    image = lt.build_image(table)
    cj = jred.compile_queries(lj, ev)
    ct = tred.compile_queries(lt, ev, device="cpu")
    ref = jred.reduce_via_layout(
        jnp.asarray(image), cj.tile_ids, cj.bitmaps,
        tile_rows=lj.tile_rows, dynamic_switch=dynamic_switch,
    )
    port = tred.reduce_via_layout(
        torch.from_numpy(image), ct.tile_ids, ct.bitmaps,
        tile_rows=lt.tile_rows, dynamic_switch=dynamic_switch,
    )
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=F32_TOL)
    oj = jred.reduce_dense_oracle(jnp.asarray(table), ev)
    ot = tred.reduce_dense_oracle(torch.from_numpy(table), ev)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=F32_TOL)
    np.testing.assert_allclose(port.numpy(), ot.numpy(), atol=1e-4)


def _flops_bitmaps(layout, dtype, seed):
    """Seeded 0/1 bitmaps whose tiles are all-zero, single-row or full,
    besides random fills."""
    rng = np.random.default_rng(seed)
    shape = (5, 6, 3, 16) if layout == "blocked" else (7, 6, 16)
    bm = (rng.random(shape) < rng.random(shape[:-1] + (1,))).astype(np.float32)
    flat = bm.reshape(-1, shape[-1])
    flat[0] = 0.0                         # all-zero (padding) tile
    flat[1] = 0.0
    flat[1, 3] = 1.0                      # single-row (READ) tile
    flat[2] = 1.0                         # full tile
    return bm.astype(jnp.bfloat16) if dtype == "bfloat16" else bm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dynamic_switch", [True, False])
@pytest.mark.parametrize("layout", ["flat", "blocked"])
@pytest.mark.parametrize("seed", [0, 1])
def test_reduction_flops_identical(layout, dynamic_switch, dtype, seed):
    bm = _flops_bitmaps(layout, dtype, seed)
    assert bm.dtype.name == dtype
    ref = jred.reduction_flops(bm, 96, dynamic_switch)
    port = tred.reduction_flops(bm, 96, dynamic_switch)
    assert type(port) is int and port == ref
    # The fixed tiles: the full one is always MAC; the single-row one is
    # MAC only without the switch.
    assert port >= (2 if not dynamic_switch else 1) * 2 * 16 * 96


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dynamic_switch", [True, False])
def test_reduction_flops_torch_tensor(dynamic_switch, dtype):
    """A CPU tensor, as the compile returns it, counts as its NumPy twin."""
    (lj, _, _), (lt, _, _) = _layouts(seed=8)
    ev = zipf_queries(512, 24, 8.0, seed=9) + [[5]]
    cj = jred.compile_queries(lj, ev)
    ct = tred.compile_queries(lt, ev, device="cpu", dtype=dtype)
    ref = jred.reduction_flops(np.asarray(cj.bitmaps), 128, dynamic_switch)
    port = tred.reduction_flops(ct.bitmaps, 128, dynamic_switch)
    assert type(port) is int and port == ref > 0


# ------------------------------------- the sparse per-shard compile --


def _sparse_setup(num_shards, with_jax=False):
    """Three tables (the third gets no queries) and their shard plan:
    ``(plan, layouts, queries, tile offsets)``, and with ``with_jax`` the
    reference's ``(plan, layouts)`` of the same tables after them."""
    both = [_layouts(seed=3), _layouts(seed=4), _layouts(seed=5)]
    plans = []
    for side, dist in ((1, tdist), (0, jdist)):
        tables = [t[side] for t in both]
        layouts = [lay for lay, _, _ in tables]
        plans.append((dist.plan_shards(layouts, [p for _, p, _ in tables], num_shards,
                                       group_freqs=[g for _, _, g in tables]), layouts))
    (sp, layouts), jax_side = plans
    evs = [zipf_queries(512, n, 8.0, seed=40 + n) for n in (13, 22)] + [[]]
    offsets = [seg.tile_offset for seg in sp.tables]
    return (sp, layouts, evs, offsets, *jax_side) if with_jax else (sp, layouts, evs, offsets)


def _dense_chain(sp, layouts, evs, offsets, q_block, dtype, red=tred):
    """The dense compile's fused batch and spans, by the port (``tred``)
    or the reference (``jred``, with a JAX ``dtype``)."""
    kw = {"device": "cpu"} if red is tred else {}
    cqs = [red.offset_compiled_queries(
        red.compile_queries(lay, ev, replica_block=q_block, dtype=dtype, **kw), off)
        for lay, ev, off in zip(layouts, evs, offsets)]
    return red.concat_compiled_queries(cqs, q_block)


def _activations(layouts, evs, q_block):
    return [tcore.compile_activations(lay, ev, replica_block=q_block)
            for lay, ev in zip(layouts, evs)]


def _owners_within(sp, layouts, evs, offsets, q_block, shards):
    """Each table's queries whose sharded-once tiles all live on ``shards``."""
    kept = []
    for lay, ev, off in zip(layouts, evs, offsets):
        acts = tcore.compile_activations(lay, ev, replica_block=q_block)
        own = np.asarray(sp.shard_of_tile)[acts.act_tile + off]
        bad = set(acts.act_qid[(own >= 0) & ~np.isin(own, shards)].tolist())
        kept.append([q for i, q in enumerate(ev) if i not in bad])
    return kept


def assert_same_sharded(ref, got):
    """Field-by-field, bit-for-bit equality of two sharded blocked batches."""
    for f in ("tile_ids", "bitmaps"):
        a, b = getattr(ref, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), f
    np.testing.assert_array_equal(ref.shard_widths, got.shard_widths)
    assert ref.shard_widths.dtype == got.shard_widths.dtype
    assert (ref.shards is None) == (got.shards is None)
    if ref.shards is not None:
        np.testing.assert_array_equal(ref.shards, got.shards)
    assert (ref.q_block, ref.batch, ref.slot_counts) == (got.q_block, got.batch, got.slot_counts)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [
    "shards1", "shards2", "shards4", "parts_reordered", "parts_subset",
    "q_block8_ragged", "all_empty", "int64_index",
])
def test_shard_block_activations_equals_the_dense_chain(case, dtype, traced, monkeypatch):
    """The sparse compile gives, bit for bit, the port's dense chain's
    batch and spans, and the reference's
    (``repro.core.reduction.shard_block_queries`` of its fused dense
    compile) on the same queries: shard counts 1, 2 and 4; participants
    reordered and a proper subset (replicated-everywhere tiles
    round-robin over them); a q_block that leaves ragged tables; a table
    with no queries in every case and only empty queries in one; f32 and
    bf16; tracing on and off."""
    from repro_torch.core import trace

    num_shards = {"shards1": 1, "shards2": 2}.get(case, 4)
    q_block = 8 if case == "q_block8_ragged" else 4
    sp, layouts, evs, offsets, spj, layouts_j = _sparse_setup(num_shards, with_jax=True)
    participants = {"parts_reordered": [3, 1, 0, 2], "parts_subset": [3, 0, 2]}.get(case)
    if case == "parts_subset":
        evs = [zipf_queries(512, 48, 3.0, seed=s) for s in (7, 8)] + [[]]
        evs = _owners_within(sp, layouts, evs, offsets, q_block, [3, 0, 2])
        own = np.asarray(sp.shard_of_tile)
        for lay, ev, off in zip(layouts, evs, offsets):   # and replicated rows
            rep_rows = np.nonzero(own[np.asarray(lay.tile_base)[lay.group_of] + off] == -1)[0]
            ev += [rep_rows[i:i + 2] for i in range(0, min(rep_rows.size, 12), 2)]
        assert min(map(len, evs[:2])) >= 5 and set(own[own >= 0]) > {3, 0, 2}
    if case == "all_empty":
        evs = [[[]] * 5, [], [[], []]]
    if case == "int64_index":
        monkeypatch.setattr(tred, "_flat_index_dtype", lambda numel: np.dtype(np.int64))
    was = trace.enabled()
    trace.set_enabled(traced)
    try:
        fused, spans = _dense_chain(sp, layouts, evs, offsets, q_block, dtype)
        ref = tred.shard_block_queries(fused, sp, q_block, participants=participants)
        got, got_spans = tred.shard_block_activations(
            _activations(layouts, evs, q_block), offsets, sp, q_block,
            participants=participants, device="cpu", dtype=dtype)
    finally:
        trace.set_enabled(was)
    assert got_spans == spans
    assert_same_sharded(ref, got)
    fused_j, spans_j = _dense_chain(spj, layouts_j, evs, [seg.tile_offset for seg in spj.tables],
                                    q_block, getattr(jnp, str(dtype).split(".")[1]), red=jred)
    assert got_spans == spans_j
    assert_same_compile(jred.shard_block_queries(fused_j, spj, q_block,
                                                 participants=participants), got)
    assert (ref.slot_counts is not None) == traced
    if case != "all_empty":
        assert int((got.bitmaps != 0).sum()) > 0
    if case == "parts_subset":
        rep = own[np.unique(fused.tile_ids[fused.tile_ids >= 0].numpy())] == -1
        assert rep.any()   # the batch activates replicated-everywhere tiles


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zeroed_bitmaps_clear_each_batch_before_the_next(dtype):
    """Batches of changing shape compiled through one kept-zeroed buffer:
    each bitmap equals the dense chain's while it is current, the buffer
    holds no one but the newest batch's, it grows to the largest grid,
    and a new dtype starts a new buffer."""
    q_block = 4
    sp, layouts, evs, offsets = _sparse_setup(4)
    scratch = tred.ZeroedBitmaps()
    batches = [evs, [ev[:3] for ev in evs], [evs[1], evs[0], []], [[[]] * 2, [], []]]
    biggest = 0
    for qs in batches:
        fused, _ = _dense_chain(sp, layouts, qs, offsets, q_block, dtype)
        ref = tred.shard_block_queries(fused, sp, q_block)
        got, _ = tred.shard_block_activations(
            _activations(layouts, qs, q_block), offsets, sp, q_block,
            device="cpu", dtype=dtype, bitmaps=scratch)
        assert_same_sharded(ref, got)
        biggest = max(biggest, got.bitmaps.numel())
        flat = scratch._flat
        assert flat.numel() == biggest and flat.dtype == dtype
        assert int((flat != 0).sum()) == int((got.bitmaps != 0).sum())
    assert biggest > got.bitmaps.numel() and int((scratch._flat != 0).sum()) == 0
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    ones = torch.tensor([0, 5], dtype=torch.int64)
    bm = scratch.take((2, 4), ones, other)
    assert bm.dtype == other and scratch._flat.numel() == 8
    assert bm.flatten().tolist() == [1, 0, 0, 0, 0, 1, 0, 0]


@pytest.mark.parametrize("fault", ["cold", "non_participant", "unheld", "participants"])
def test_shard_block_activations_raises_as_the_dense_chain(fault):
    """A cold tile, a tile owned outside the participants, one its owner
    does not hold and a bad participant list raise the same errors."""
    q_block = 4
    sp, layouts, evs, offsets = _sparse_setup(4)
    acts = _activations(layouts, evs, q_block)
    tile = int(acts[0].act_tile[0] + offsets[0])
    participants = None
    if fault == "cold":
        sot = np.asarray(sp.shard_of_tile).copy()
        sot[tile] = -2
        sp = dataclasses.replace(sp, shard_of_tile=sot)
    elif fault == "non_participant":
        participants = [0]
    elif fault == "unheld":
        lto = np.asarray(sp.local_tile_of).copy()
        lto[:, tile] = -1
        sot = np.asarray(sp.shard_of_tile).copy()
        sot[tile] = 1
        sp = dataclasses.replace(sp, shard_of_tile=sot, local_tile_of=lto)
    else:
        participants = [1, 1]
    fused, _ = _dense_chain(sp, layouts, evs, offsets, q_block, torch.float32)
    with pytest.raises(ValueError) as dense:
        tred.shard_block_queries(fused, sp, q_block, participants=participants)
    with pytest.raises(ValueError) as sparse:
        tred.shard_block_activations(acts, offsets, sp, q_block,
                                     participants=participants, device="cpu")
    assert str(sparse.value) == str(dense.value)


@pytest.mark.parametrize("numel, want", [
    (0, np.int32), ((1 << 31) - 1, np.int32), (1 << 31, np.int64),
    # the (P, nb, max_tiles, q_block, tile_rows) products, never allocated
    (1 * 4096 * 512 * 8 * 128, np.int64), (4 * 256 * 48 * 8 * 64, np.int32),
    (2 * 8192 * 1024 * 16 * 64, np.int64),
])
def test_flat_index_dtype_at_two_to_the_31(numel, want):
    assert tred._flat_index_dtype(numel) == np.dtype(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_drift_loads_equal_the_dense_compiles(dtype):
    """The server's sparse observation gives ``fused_group_loads`` of the
    dense compile exactly, and the memo hits on a replay."""
    from repro_torch.serve import LoadObservationCache

    q_block = 4
    sp, layouts, evs, offsets = _sparse_setup(2)
    tile_group = np.repeat(np.arange(sp.num_groups), sp.group_copies)
    fused, _ = _dense_chain(sp, layouts, evs, offsets, q_block, dtype)
    sparse = tred.FusedActivations.of(_activations(layouts, evs, q_block), offsets)
    want = tred.fused_group_loads(fused, tile_group, sp.num_groups)
    got = tred.activation_group_loads(sparse, tile_group, sp.num_groups)
    assert got.dtype == want.dtype == np.float64 and want.sum() > 0
    np.testing.assert_array_equal(got, want)
    cache = LoadObservationCache()
    np.testing.assert_array_equal(cache.loads(sparse, tile_group, sp.num_groups), want)
    replay = tred.FusedActivations.of(_activations(layouts, evs, q_block), offsets)
    cache.loads(replay, tile_group, sp.num_groups)
    other = tred.FusedActivations.of(_activations(layouts, evs[::-1], q_block), offsets[::-1])
    cache.loads(other, tile_group, sp.num_groups)
    assert (cache.hits, cache.misses) == (1, 2)
