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
