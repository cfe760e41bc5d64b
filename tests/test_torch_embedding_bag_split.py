"""The embedding-bag kernel's split arithmetic, launch plan and dtype
contract on the CPU.

The CUDA kernel splits each bag's positions ``[0, K)`` into ``n_split``
contiguous ranges (:func:`embedding_bag_k_ranges`), sums each range in f32
in one lane group and adds the ranges' partials in split order;
``embedding_bag_split_ref`` repeats that order in plain PyTorch.  Here it
is held against the JAX package's oracle (``repro.kernels.ref``) and, at
small shapes, ``embedding_bag_pallas`` in interpret mode, on seeded numpy
inputs at every split count, in f32, bf16 and f16, with padding anywhere
in a bag, a bag of padding and out-of-range ids.  On integer-valued tables
the results must be bit-identical.  The kernel itself runs only on the
card (``chip_smoke.py`` holds it against the same split version there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro_torch.convert import _tensor
from repro_torch.kernels import embedding_bag_cuda, ops
from repro_torch.kernels.embedding_bag import (
    MAX_SPLIT, ROWS_IN_FLIGHT, SPLITS, THREADS, embedding_bag_launch_plan,
    embedding_bag_split_count, group_lanes,
)
from repro_torch.kernels.ref import embedding_bag_k_ranges, embedding_bag_split_ref

# tests/test_kernels.py's tolerances (f32 atol 1e-5; bf16 atol 0.15, rtol
# 1e-2); f16 keeps 11 significant bits, and its outputs here stay under 16
# in size, so 2 of its ulps there are 2**-5 (the crossbar split tests' f16
# tolerance)
TOL = {
    "float32": dict(atol=1e-5, rtol=0),
    "bfloat16": dict(atol=0.15, rtol=1e-2),
    "float16": dict(atol=2 ** -5, rtol=1e-3),
}
NP_DTYPE = {"float32": np.float32, "bfloat16": jnp.bfloat16, "float16": np.float16}
B, K = 5, 9  # bags and positions of the split cases


def _case(rng, rows, D, batch, bag, dtype, integer):
    """Seeded table and indices: padding at random positions (not only at
    the end), bag 1 all padding, ids past ``rows`` (read the last row).
    Integer tables hold -8..8, so every partial sum of up to 32 rows is
    exact in every dtype (bf16 integers are exact up to 256)."""
    if integer:
        table = rng.integers(-8, 9, size=(rows, D)).astype(np.float32)
    else:
        table = (rng.normal(size=(rows, D)) / 2).astype(np.float32)
    table = table.astype(NP_DTYPE[dtype])
    idx = rng.integers(0, rows + 4, size=(batch, bag)).astype(np.int32)
    idx[rng.random((batch, bag)) < 0.3] = -1
    if batch > 1:
        idx[1] = -1
    if bag > 1:
        idx[0, 1] = rows + 11
    return table, idx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _check(out, want, dtype, integer, msg=""):
    if integer:
        np.testing.assert_array_equal(_f32(out), _f32(want), err_msg=msg)
    else:
        np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype], err_msg=msg)


@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 8, 16, 33, 70])
@pytest.mark.parametrize("bag", [0, 1, 2, 3, 7, 8, 9, 64, 65])
def test_k_ranges_cover_every_position_once(bag, n_split):
    ranges = embedding_bag_k_ranges(bag, n_split)
    assert len(ranges) == n_split
    assert [k for lo, hi in ranges for k in range(lo, hi)] == list(range(bag))
    assert all(lo <= hi for lo, hi in ranges)
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1
    if n_split <= bag:
        assert min(sizes) >= 1


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("D", [128, 256, 4096])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("n_split", [1, 2, 3, 8, K + 3])
def test_split_ref_matches_jax_oracle(n_split, dtype, D, integer):
    rng = np.random.default_rng([n_split, D, len(dtype), integer])
    table, idx = _case(rng, 40, D, B, K, dtype, integer)
    want = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx))
    t_table, t_idx = _tensor(table, "cpu"), _tensor(idx, "cpu")
    out = embedding_bag_split_ref(t_table, t_idx, n_split)
    assert out.shape == (B, D) and out.dtype == t_table.dtype
    _check(out, want, dtype, integer)
    assert not _f32(out)[1].any()  # the bag of padding sums to zero
    # the CPU wrapper with the split forced runs the same plain version
    assert torch.equal(embedding_bag_cuda(t_table, t_idx, n_split=n_split), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_integer_tables_are_bit_identical_at_every_split(dtype):
    """Every order of an exact sum gives the same bits: each split, the
    unsplit plain version and the JAX oracle agree bit for bit."""
    rng = np.random.default_rng(len(dtype))
    table, idx = _case(rng, 300, 256, 16, 32, dtype, integer=True)
    t_table, t_idx = _tensor(table, "cpu"), _tensor(idx, "cpu")
    want = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx))
    base = embedding_bag_cuda(t_table, t_idx)
    np.testing.assert_array_equal(_f32(base), _f32(want))
    for n_split in range(1, MAX_SPLIT + 1):
        out = embedding_bag_split_ref(t_table, t_idx, n_split)
        assert torch.equal(out, base), n_split


SHAPES = [  # rows, D, B, K — tests/test_kernels.py's sweep
    (64, 128, 4, 8),
    (100, 128, 2, 5),
    (257, 256, 8, 16),
    (16, 512, 1, 3),
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_split_ref_matches_interpret_pallas(shape, dtype):
    rows, D, batch, bag = shape
    rng = np.random.default_rng([rows, D, batch, bag, len(dtype)])
    table = (rng.normal(size=(rows, D)) / 2).astype(NP_DTYPE[dtype])
    idx = rng.integers(0, rows, size=(batch, bag)).astype(np.int32)
    idx[:, -1] = -1
    idx[:, 0] = -1  # padding ahead of valid ids
    want = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(idx), interpret=True)
    t_table, t_idx = _tensor(table, "cpu"), _tensor(idx, "cpu")
    for n_split in (1, 2, 3, 8, bag + 1):
        _check(embedding_bag_split_ref(t_table, t_idx, n_split), want, dtype, False,
               msg=f"n_split={n_split}")


@pytest.mark.parametrize("batch,bag,dim,itemsize,per_sm,want", [
    # the main path at an H100's 132 SMs: 8 warps (f32) or 8 half-warps a
    # bag, ranges of 8 positions
    (256, 64, 128, 4, 4, dict(n_split=8, bags_per_block=1, grid=(256, 1), group_lanes=32)),
    (256, 64, 128, 2, 4, dict(n_split=8, bags_per_block=2, grid=(128, 1), group_lanes=16)),
    (256, 128, 128, 2, 4, dict(n_split=16, bags_per_block=1, grid=(256, 1))),
    # 4,096 bags fill a wave unsplit; with twice the blocks an SM, split in 2
    (4096, 64, 128, 4, 4, dict(n_split=1, bags_per_block=8, grid=(512, 1))),
    (4096, 64, 128, 4, 8, dict(n_split=2, bags_per_block=4, grid=(1024, 1))),
    # token-embedding gather: bags of one id, 32 column chunks
    (2048, 1, 4096, 2, 4, dict(n_split=1, bags_per_block=16, grid=(128, 32))),
    # an empty bag, and no bags
    (8, 0, 256, 4, 4, dict(n_split=1, bags_per_block=8, grid=(1, 2))),
    (0, 64, 128, 4, 4, dict(n_split=8, bags_per_block=1, grid=(0, 1))),
    # no range shorter than the rows in flight
    (3, 15, 128, 2, 4, dict(n_split=1, bags_per_block=16, grid=(1, 1))),
    (3, 16, 128, 2, 4, dict(n_split=2, bags_per_block=8, grid=(1, 1))),
])
def test_launch_plan(batch, bag, dim, itemsize, per_sm, want):
    plan = embedding_bag_launch_plan(batch, bag, dim, itemsize, blocks_per_sm=per_sm)
    assert plan.block == THREADS
    for key, value in want.items():
        assert getattr(plan, key) == value, key


@pytest.mark.parametrize("n_split,itemsize,block,bags_per_block", [
    (1, 4, 256, 8), (3, 4, 256, 2), (8, 4, 256, 1), (9, 4, 288, 1), (16, 4, 512, 1),
    (1, 2, 256, 16), (3, 2, 256, 5), (5, 2, 256, 3), (16, 2, 256, 1),
])
def test_forced_split_sizes_the_block(n_split, itemsize, block, bags_per_block):
    plan = embedding_bag_launch_plan(100, 64, 256, itemsize, n_split=n_split)
    lanes = group_lanes(itemsize)
    assert (plan.block, plan.bags_per_block, plan.n_split) == (block, bags_per_block, n_split)
    assert plan.block % 32 == 0 and plan.block <= 512
    assert plan.bags_per_block * n_split * lanes <= plan.block
    assert plan.grid == (-(-100 // bags_per_block), 2)


@pytest.mark.parametrize("batch", [1, 64, 256, 1000, 4096, 20000])
@pytest.mark.parametrize("bag", [0, 1, 5, 16, 64, 200])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_split_count_fills_at_most_one_wave(batch, bag, itemsize):
    gpb = THREADS // group_lanes(itemsize)

    def blocks(n):
        return -(-batch // (gpb // n))

    for sms, per_sm in ((132, 4), (132, 8), (8, 2)):
        n = embedding_bag_split_count(batch, bag, 1, gpb, sms, per_sm)
        assert n in SPLITS and n <= gpb
        assert n == 1 or n * ROWS_IN_FLIGHT <= bag
        if n > 1:
            assert blocks(n) <= per_sm * sms
        bigger = [s for s in SPLITS if s > n]
        if bigger and bigger[0] * ROWS_IN_FLIGHT <= bag and bigger[0] <= gpb:
            assert blocks(bigger[0]) > per_sm * sms


@pytest.mark.parametrize("kw,err", [
    (dict(dim=100), ValueError), (dict(dim=0), ValueError), (dict(itemsize=8), TypeError),
    (dict(n_split=0), ValueError), (dict(n_split=MAX_SPLIT + 1), ValueError),
    (dict(n_split=2.0), TypeError),
])
def test_launch_plan_refuses(kw, err):
    args = dict(batch=4, bag=8, dim=128, itemsize=4) | kw
    with pytest.raises(err):
        embedding_bag_launch_plan(**args)


def test_cpu_wrapper_serves_f16_tables():
    """An f16 table takes the plain version on the CPU, in f16 out, summed
    in f32, forward and backward through the op."""
    rng = np.random.default_rng(7)
    table, idx = _case(rng, 50, 128, 6, 10, "float16", integer=False)
    t_table, t_idx = _tensor(table, "cpu"), _tensor(idx, "cpu")
    out = embedding_bag_cuda(t_table, t_idx)
    assert out.dtype == torch.float16 and out.shape == (6, 128)
    want = jref.embedding_bag_ref(jnp.asarray(table.astype(np.float32)), jnp.asarray(idx))
    np.testing.assert_allclose(_f32(out), np.asarray(want), **TOL["float16"])
    leaf = t_table.clone().requires_grad_(True)
    (ops.embedding_bag(leaf, t_idx).float() ** 2).sum().backward()
    assert leaf.grad.dtype == torch.float16 and leaf.grad.shape == leaf.shape
    assert torch.isfinite(leaf.grad).all()


@pytest.mark.parametrize("n_split,err", [
    (0, ValueError), (-1, ValueError), (MAX_SPLIT + 1, ValueError),
    (2.0, TypeError), (True, TypeError), ("2", TypeError),
])
def test_wrapper_checks_n_split(n_split, err):
    rng = np.random.default_rng(8)
    table, idx = (_tensor(a, "cpu") for a in _case(rng, 20, 128, 3, 4, "float32", False))
    with pytest.raises(err):
        embedding_bag_cuda(table, idx, n_split=n_split)
    with pytest.raises(err):  # checked before the device is
        embedding_bag_cuda(table.to("meta"), idx.to("meta"), n_split=n_split)
    assert torch.equal(embedding_bag_cuda(table, idx, n_split=MAX_SPLIT),
                       embedding_bag_split_ref(table, idx, MAX_SPLIT))
