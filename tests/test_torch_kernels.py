"""Crossbar kernel parity on the CPU: the port's plain versions (what its
wrappers run on CPU tensors) against ``repro.kernels.ref`` and against
``crossbar_reduce_pallas`` in interpret mode, flat and query-blocked,
f32 and bf16, dynamic switch on and off, gradients included.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the same plain versions there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import crossbar_reduce as j_crossbar_reduce
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.crossbar_reduce import crossbar_reduce_pallas
from repro_torch.convert import _tensor
from repro_torch.kernels import crossbar_reduce_cuda, ops

# tests/test_kernels.py's tolerances: f32 atol 1e-5; bf16 atol 0.15, rtol 1e-2
TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=0.15, rtol=1e-2)}

SHAPES = [  # T, R, D, B, S — tests/test_kernels.py's sweep
    (4, 8, 128, 2, 4),
    (12, 16, 128, 4, 8),
    (7, 8, 256, 3, 8),
    (32, 64, 128, 8, 16),
    (3, 8, 512, 1, 4),
]


def _case(rng, T, R, D, B, S, q_block=None, dtype="float32"):
    """Seeded numpy inputs with padding slots, READ-path (single-hot) and
    activated-but-empty tiles; 4-D bitmaps when ``q_block`` is given."""
    np_dtype = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    image = rng.normal(size=(T, R, D)).astype(np_dtype)
    ids = rng.integers(0, T, size=(B, S)).astype(np.int32)
    npad = max(1, S // 4)
    ids[:, -npad:] = -1
    lanes = (B, S, R) if q_block is None else (B, S, q_block, R)
    bm = (rng.random(lanes) < 0.08).astype(np_dtype)
    bm[:, -npad:] = 0
    for b in range(B):
        if rng.random() < 0.3 and S > npad:
            bm[b, 0] = 0
            bm[b, 0].reshape(-1)[int(rng.integers(0, bm[b, 0].size))] = 1
        if S - npad > 1:
            bm[b, 1] = 0
    return image, ids, bm


def _torch(*arrays):
    return [_tensor(a, "cpu") for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_plain_matches_reference(shape, dtype):
    T, R, D, B, S = shape
    rng = np.random.default_rng(T * 1000 + R + D + B + S)
    image, ids, bm = _case(rng, *shape, dtype=dtype)
    out = crossbar_reduce_cuda(*_torch(image, ids, bm))
    assert out.shape == (B, D) and out.dtype == getattr(torch, dtype)
    want = jax.jit(jref.crossbar_reduce_ref)(image, ids, bm)
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES[1:4])
@pytest.mark.parametrize("q_block", [1, 8])
def test_blocked_plain_matches_reference(shape, q_block):
    T, R, D, B, S = shape
    rng = np.random.default_rng(7 * T + R + q_block)
    image, ids, bm = _case(rng, *shape, q_block=q_block)
    out = crossbar_reduce_cuda(*_torch(image, ids, bm))
    want = jax.jit(jref.crossbar_reduce_blocked_ref)(image, ids, bm)
    assert out.shape == (B * q_block, D)
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("layout,shape", [
    ("flat", (7, 8, 256, 3, 8)),
    ("blocked", (8, 64, 128, 2, 4)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dynamic_switch", [True, False])
def test_plain_matches_interpret_pallas(layout, shape, dtype, dynamic_switch):
    rng = np.random.default_rng(sum(shape) + dynamic_switch)
    image, ids, bm = _case(
        rng, *shape, q_block=4 if layout == "blocked" else None, dtype=dtype
    )
    out = crossbar_reduce_cuda(*_torch(image, ids, bm), dynamic_switch=dynamic_switch)
    want = crossbar_reduce_pallas(
        jnp.asarray(image), jnp.asarray(ids), jnp.asarray(bm),
        dynamic_switch=dynamic_switch, interpret=True,
    )
    assert out.shape == want.shape
    np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("layout", ["flat", "blocked"])
def test_grad_matches_jax_custom_vjp(layout):
    rng = np.random.default_rng(1)
    q_block = 4 if layout == "blocked" else None
    image, ids, bm = _case(rng, 8, 16, 128, 4, 8, q_block=q_block)
    j_op = jops.crossbar_reduce_blocked if q_block else j_crossbar_reduce
    t_op = ops.crossbar_reduce_blocked if q_block else ops.crossbar_reduce
    gj = jax.grad(lambda img: (j_op(img, jnp.asarray(ids), jnp.asarray(bm)) ** 2).sum())(
        jnp.asarray(image)
    )
    img_t, ids_t, bm_t = _torch(image, ids, bm)
    img_t.requires_grad_(True)
    (t_op(img_t, ids_t, bm_t) ** 2).sum().backward()
    np.testing.assert_allclose(img_t.grad.numpy(), np.asarray(gj), atol=1e-5, rtol=0)


def test_cpu_path_counts_no_launch_and_rejects_other_devices():
    rng = np.random.default_rng(2)
    image, ids, bm = _torch(*_case(rng, 4, 8, 128, 2, 4))
    before = crossbar_reduce_cuda.launches
    crossbar_reduce_cuda(image, ids, bm)
    assert crossbar_reduce_cuda.launches == before
    with pytest.raises(ValueError, match="one device"):
        crossbar_reduce_cuda(image.to("meta"), ids.to("meta"), bm.to("meta"))
    with pytest.raises(ValueError, match="one device"):
        crossbar_reduce_cuda(image.to("meta"), ids, bm)


@pytest.mark.parametrize("bad", ["dim", "rows", "bitmap"])
def test_contract_errors(bad):
    rng = np.random.default_rng(3)
    image, ids, bm = _torch(*_case(rng, 4, 8, 128, 2, 4))
    if bad == "dim":
        image = image[..., :64]
    elif bad == "rows":
        image, bm = image[:, :4], bm[..., :4]
    else:
        bm = bm[:, :3]
    with pytest.raises(ValueError):
        crossbar_reduce_cuda(image, ids, bm)
