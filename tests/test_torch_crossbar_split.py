"""The crossbar kernel's split arithmetic and launch plan on the CPU.

The CUDA kernel splits each query block's slots, up to its row's last
non-padding one, over a cluster of ``n_split`` blocks
(:func:`crossbar_split_count`, :func:`crossbar_row_widths`,
:func:`crossbar_slot_ranges`) and adds the splits' f32 partials in rank
order; ``crossbar_reduce_split_ref``
repeats that order in plain PyTorch.  Here it is held against the JAX
package's oracles (``repro.kernels.ref``) on seeded numpy inputs at every
split count, over the reference's whole contract: any ``q_block``,
``tile_rows`` up to 1024, f32, bf16 and f16.  On integer-valued images the
results must be bit-identical.  The kernel itself runs only on the card
(``chip_smoke.py`` holds it against the same split version there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import zipf_queries
from repro.kernels import ref as jref
from repro.serve import ShardedEmbeddingServer as JaxServer
from repro_torch.convert import _tensor, tables_from_numpy
from repro_torch.kernels import crossbar_reduce as xb
from repro_torch.kernels import crossbar_reduce_cuda
from repro_torch.kernels.crossbar_reduce import (
    SPLITS, crossbar_launch_plan, crossbar_q_chunk, crossbar_split_count,
)
from repro_torch.kernels.ref import (
    crossbar_reduce_split_ref, crossbar_row_widths, crossbar_slot_ranges,
)
from repro_torch.serve import ShardedEmbeddingServer as TorchServer

# tests/test_kernels.py's tolerances (f32 atol 1e-5; bf16 atol 0.15, rtol
# 1e-2); f16 keeps 11 significant bits, and its outputs here stay under 16
# in size, so 2 of its ulps there are 2**-5
TOL = {
    "float32": dict(atol=1e-5, rtol=0),
    "bfloat16": dict(atol=0.15, rtol=1e-2),
    "float16": dict(atol=2 ** -5, rtol=1e-3),
}
NP_DTYPE = {"float32": np.float32, "bfloat16": jnp.bfloat16, "float16": np.float16}


def _case(rng, T, R, D, nb, S, q_block, dtype, integer):
    """Seeded inputs with padding slots, a single-hot (READ-path) slot and
    an activated-but-empty slot; ``q_block=None`` gives flat bitmaps.
    Integer images keep every partial sum exact in the image dtype: values
    in -8..8 for f32, -1..1 at low density for the 16-bit types (whose
    integers are exact only up to 256 and 2048)."""
    if integer:
        hi = 8 if dtype == "float32" else 1
        image = rng.integers(-hi, hi + 1, size=(T, R, D)).astype(np.float32)
    else:
        image = rng.normal(size=(T, R, D)).astype(np.float32)
    image = image.astype(NP_DTYPE[dtype])
    ids = rng.integers(0, T + 2, size=(nb, S)).astype(np.int32)  # ids >= T read the last tile
    ids[:, -max(1, S // 4):] = -1
    ids[0, S // 2:] = -1   # a narrower row
    ids[-1, 2] = -1        # padding inside a row
    lanes = (nb, S, R) if q_block is None else (nb, S, q_block, R)
    density = 0.08 if R <= 64 else 0.01
    bm = (rng.random(lanes) < density).astype(np.float32)
    bm[ids < 0] = 0
    flat = bm.reshape(nb, S, -1)
    flat[:, 0] = 0
    flat[:, 0, int(rng.integers(0, flat.shape[2]))] = 1
    flat[:, 1] = 0
    return image, ids, bm.astype(NP_DTYPE[dtype])


def _jax_oracle(image, ids, bm):
    fn = jref.crossbar_reduce_ref if bm.ndim == 3 else jref.crossbar_reduce_blocked_ref
    return np.asarray(fn(jnp.asarray(image), jnp.asarray(ids), jnp.asarray(bm)), np.float32)


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("nb", [1, 2, 16, 33, 64, 256, 4096])
@pytest.mark.parametrize("S", [0, 1, 2, 3, 7, 8, 9, 24, 48, 200])
def test_split_count_and_ranges_cover_every_slot_once(nb, S):
    for sms, per_sm in ((132, 3), (132, 4), (8, 2)):
        n = crossbar_split_count(nb, S, sms, per_sm)
        assert n in SPLITS and n <= max(1, S)
        # the largest split whose blocks fit one wave, unless S caps it
        if n > 1:
            assert nb * n <= per_sm * sms
        if n < SPLITS[-1] and 2 * n <= S:
            assert nb * 2 * n > per_sm * sms
        for forced in SPLITS:
            ranges = crossbar_slot_ranges(S, forced)
            assert len(ranges) == forced
            assert [s for lo, hi in ranges for s in range(lo, hi)] == list(range(S))
            if forced <= S:
                assert all(hi > lo for lo, hi in ranges)
            sizes = [hi - lo for lo, hi in ranges]
            assert max(sizes) - min(sizes) <= 1


def test_row_widths_end_at_the_last_non_padding_slot():
    ids = np.array([[3, -1, 2, -1, -1], [-1] * 5, [1, 2, 3, 4, 5], [-1, -1, 7, -1, -1]],
                   dtype=np.int32)
    assert crossbar_row_widths(torch.from_numpy(ids)).tolist() == [3, 0, 5, 3]
    assert crossbar_row_widths(torch.from_numpy(ids[:, :0])).tolist() == [0] * 4
    rng = np.random.default_rng(11)
    ids = np.where(rng.random((64, 40)) < 0.3, rng.integers(0, 9, (64, 40)), -1)
    want = [max([s + 1 for s in range(40) if ids[n, s] >= 0], default=0) for n in range(64)]
    assert crossbar_row_widths(torch.from_numpy(ids.astype(np.int32))).tolist() == want


@pytest.mark.parametrize("q_block", [None, 1, 3, 8, 16, 24, 32])
@pytest.mark.parametrize("tile_rows", [8, 64, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("integer", [True, False])
def test_split_ref_matches_jax_oracle(q_block, tile_rows, dtype, integer):
    rng = np.random.default_rng([q_block or 0, tile_rows, len(dtype), integer])
    nb, S = (3, 9) if tile_rows < 1024 else (2, 5)
    image, ids, bm = _case(rng, 6, tile_rows, 128, nb, S, q_block, dtype, integer)
    want = _jax_oracle(image, ids, bm)
    t_image, t_ids, t_bm = (_tensor(a, "cpu") for a in (image, ids, bm))
    outs = {f"split{n}": crossbar_reduce_split_ref(t_image, t_ids, t_bm, n) for n in SPLITS}
    for sw in (True, False):  # the CPU wrapper: the plain version, switch on and off
        outs[f"wrapper{sw}"] = crossbar_reduce_cuda(t_image, t_ids, t_bm, dynamic_switch=sw)
    q = 1 if q_block is None else q_block
    for name, out in outs.items():
        assert out.shape == (nb * q, 128) and out.dtype == t_image.dtype, name
        if integer:
            np.testing.assert_array_equal(_f32(out), want, err_msg=name)
        else:
            np.testing.assert_allclose(_f32(out), want, **TOL[dtype], err_msg=name)
    if integer:  # every order of an exact sum gives the same bits
        for out in outs.values():
            assert torch.equal(out, outs["split1"])


@pytest.mark.parametrize("q_block,q_chunk,q_chunks", [
    (1, 1, 1), (2, 2, 1), (3, 4, 1), (5, 8, 1), (8, 8, 1), (16, 16, 1),
    (17, 16, 2), (24, 16, 2), (32, 16, 2), (33, 16, 3),
])
def test_launch_plan_serves_any_q_block(q_block, q_chunk, q_chunks):
    plan = crossbar_launch_plan(16, 48, q_block, 64, 128)
    assert crossbar_q_chunk(q_block) == q_chunk
    assert (plan.q_chunk, plan.q_chunks) == (q_chunk, q_chunks)
    assert plan.grid == (16 * plan.n_split, 1, q_chunks)
    assert plan.cluster == (plan.n_split, 1, 1) and plan.block == 128
    assert plan.n_split == crossbar_split_count(16 * q_chunks, 48)


def test_launch_plan_takes_the_reference_contract_and_refuses_the_rest():
    # a 64 KB f32 bitmap (q 16 x 1024 rows) and the widths the old kernel refused
    plan = crossbar_launch_plan(4, 16, 16, 1024, 256)
    assert plan.grid[1:] == (2, 1)
    # an H100 holds 4 blocks of the q_chunk 1 instance an SM and 3 of the q_chunk 8 one
    assert crossbar_launch_plan(256, 32, 1, 64, 128, blocks_per_sm=4).n_split == 2  # flat
    assert crossbar_launch_plan(16, 48, 8, 64, 128, blocks_per_sm=3).n_split == 8  # a flush chunk
    assert crossbar_launch_plan(64, 128, 8, 64, 128, blocks_per_sm=3).n_split == 4
    assert crossbar_launch_plan(16, 48, 8, 64, 128, n_split=1).grid == (16, 1, 1)
    assert crossbar_launch_plan(0, 0, 3, 64, 128).n_split == 1
    for bad in (dict(q_block=0), dict(tile_rows=12), dict(dim=100), dict(n_split=3)):
        kw = dict(nb=4, S=8, q_block=3, tile_rows=64, dim=128) | bad
        with pytest.raises(ValueError):
            crossbar_launch_plan(**kw)
    assert not hasattr(xb, "Q_BLOCKS") and not hasattr(xb, "_SMEM_LIMIT")


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_cpu_wrapper_keeps_16_bit_dtypes(dtype):
    rng = np.random.default_rng(5)
    image, ids, bm = _case(rng, 4, 16, 128, 2, 6, 3, "float32", True)
    t = [_tensor(a, "cpu") for a in (image, ids, bm)]
    out = crossbar_reduce_cuda(t[0].to(dtype), t[1], t[2].to(dtype), n_split=2)
    assert out.dtype == dtype and out.shape == (6, 128)
    np.testing.assert_array_equal(_f32(out), _jax_oracle(image, ids, bm))


@pytest.mark.parametrize("q_block", [3, 32])
def test_server_outside_the_old_q_blocks_matches_reference(q_block):
    """``ShardedEmbeddingServer(q_block=3)`` (and 32) drains the JAX
    server's rows bit for bit on integer-valued tables."""
    rng = np.random.default_rng(q_block)
    rows = {"a": 192, "b": 320}
    tables = {n: rng.integers(-8, 9, size=(r, 128)).astype(np.float32) for n, r in rows.items()}
    histories = {n: zipf_queries(r, 64, 6.0, seed=q_block + i)
                 for i, (n, r) in enumerate(rows.items())}
    stream = [("a" if i % 3 else "b", q)
              for i, q in enumerate(zipf_queries(192, 40, 6.0, seed=q_block + 9))]
    kw = dict(num_shards=2, q_block=q_block, group_size=16, batch_size=12)
    ref = JaxServer(tables, histories, mesh=None, **kw)
    port = TorchServer(tables_from_numpy(tables, "cpu"), histories, device="cpu", **kw)
    drained = 0
    for name, q in stream:
        got_ref, got_port = ref.submit(name, q), port.submit(name, q)
        assert sorted(got_ref) == sorted(got_port)
        for n in got_ref:
            np.testing.assert_array_equal(np.asarray(got_ref[n]), got_port[n].numpy())
            drained += len(got_port[n])
    tail_ref, tail_port = ref.flush(), port.flush()
    assert sorted(tail_ref) == sorted(tail_port)
    for n in tail_ref:
        np.testing.assert_array_equal(np.asarray(tail_ref[n]), tail_port[n].numpy())
        drained += len(tail_port[n])
    assert drained == len(stream)
    assert port.report()["serve"]["q_block"] == q_block
