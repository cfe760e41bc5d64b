"""Embedding-bag parity on the CPU: the port's op (what its wrapper runs on
CPU tensors, the plain version) against ``embedding_bag_pallas`` in
interpret mode and against ``repro.kernels.ref``, f32 and bf16, with its
gradient against JAX's ``custom_vjp``.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the same plain version there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro_torch.convert import _tensor
from repro_torch.kernels import embedding_bag_cuda, ops, ref

# tests/test_kernels.py's tolerances: f32 atol 1e-5; bf16 atol 0.15, rtol 1e-2
TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=0.15, rtol=1e-2)}

SHAPES = [  # rows, D, B, K — tests/test_kernels.py's sweep
    (64, 128, 4, 8),
    (100, 128, 2, 5),
    (257, 256, 8, 16),
    (16, 512, 1, 3),
]


def _case(rng, rows, D, B, K, dtype="float32"):
    """Seeded table and -1-padded indices (last column always padding)."""
    np_dtype = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    table = rng.normal(size=(rows, D)).astype(np_dtype)
    idx = rng.integers(0, rows, size=(B, K)).astype(np.int32)
    idx[:, -1] = -1
    return table, idx


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_interpret_pallas(shape, dtype):
    rows, D, B, K = shape
    rng = np.random.default_rng(rows + D + B + K)
    table, idx = _case(rng, *shape, dtype=dtype)
    out = ops.embedding_bag(_tensor(table, "cpu"), _tensor(idx, "cpu"))
    assert out.shape == (B, D) and out.dtype == getattr(torch, dtype)
    want = embedding_bag_pallas(jnp.asarray(table), jnp.asarray(idx), interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype])


def test_plain_version_clamps_like_reference():
    """Indices at or past ``rows`` read the last row, as the oracle clamps."""
    rng = np.random.default_rng(5)
    table, idx = _case(rng, 40, 128, 6, 7)
    idx[:, 0] = 40 + rng.integers(0, 5, size=6)
    out = ref.embedding_bag_ref(_tensor(table, "cpu"), _tensor(idx, "cpu"))
    want = jref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grad_matches_jax_custom_vjp(dtype):
    rng = np.random.default_rng(3)
    table, idx = _case(rng, 50, 128, 4, 6, dtype=dtype)
    idx[0, :3] = idx[0, 3]  # a row repeated in one bag is counted each time
    gj = jax.grad(lambda t: (jops.embedding_bag(t, jnp.asarray(idx)).astype(
        jnp.float32) ** 2).sum())(jnp.asarray(table))
    t = _tensor(table, "cpu").requires_grad_(True)
    (ops.embedding_bag(t, _tensor(idx, "cpu")).float() ** 2).sum().backward()
    assert t.grad.dtype == t.dtype
    np.testing.assert_allclose(_f32(t.grad), _f32(gj), **TOL[dtype])


def test_cpu_path_counts_no_launch_and_rejects_other_devices():
    rng = np.random.default_rng(2)
    table, idx = (_tensor(a, "cpu") for a in _case(rng, 32, 128, 3, 4))
    before = embedding_bag_cuda.launches
    embedding_bag_cuda(table, idx)
    ops.embedding_bag(table, idx)
    assert embedding_bag_cuda.launches == before
    with pytest.raises(ValueError, match="one device"):
        embedding_bag_cuda(table.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        embedding_bag_cuda(table.to("meta"), idx)


@pytest.mark.parametrize("bad", ["dim", "table_rank", "indices_rank"])
def test_contract_errors(bad):
    rng = np.random.default_rng(4)
    table, idx = (_tensor(a, "cpu") for a in _case(rng, 32, 128, 3, 4))
    if bad == "dim":
        table = table[:, :100]
    elif bad == "table_rank":
        table = table[None]
    else:
        idx = idx[0]
    with pytest.raises(ValueError):
        embedding_bag_cuda(table, idx)
    with pytest.raises(ValueError):
        ops.embedding_bag(table, idx)
