"""The port's xLSTM cells against the JAX package, on the CPU:
``init_mlstm``/``init_slstm`` trees, ``mlstm_scan``, ``mlstm_chunked``
(with and without padding), ``slstm_scan``, the two one-token decode
steps, each with its final state, and the gradients of the chunked mLSTM
and the sLSTM under long gates.

JAX's parameters are carried across by ``repro_torch.convert``; inputs
are drawn with numpy.  Tolerances: float32 outputs and states atol 1e-5
(rtol 1e-5), the chunked form against its own reference 3e-5 as
``tests/test_models_numerics.py:22`` holds it against the scan; bfloat16
atol 0.15, rtol 1e-2; gradients rtol 1e-4 and atol 1e-4 × max(1, the
leaf's largest |gradient|): XLA and torch sum the float32 products in
other orders, and where the normalizer ``max(|q·n|, exp(-m))`` is small
the gradients reach 10³-10⁴ and cancel, so a fixed atol would measure
float32's rounding of the largest terms, not the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jx
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import xlstm as tx
from repro_torch.models.layers import tree_map

TOL = dict(atol=1e-5, rtol=1e-5)
CHUNK_TOL = dict(atol=3e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.15, rtol=1e-2)
GRAD_RTOL = 1e-4
D, H = 64, 4


def _params(kind, d=D, h=H, dtype=jnp.float32, seed=0):
    init = jx.init_mlstm if kind == "m" else jx.init_slstm
    jp = init(jax.random.PRNGKey(seed), d, h, dtype)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, scale=0.5, seed=1):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, **tol):
    for w, g in zip(jax.tree.leaves(want), _leaves(got), strict=True):
        np.testing.assert_allclose(g.detach().float().numpy(), np.asarray(w, np.float32), **tol)


def _leaves(t):
    return [t] if isinstance(t, torch.Tensor) else [x for y in t for x in _leaves(y)]


@pytest.mark.parametrize("kind", ["m", "s"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_init_trees_match_jax(kind, dtype):
    jp, _ = _params(kind, dtype=dtype)
    init = tx.init_mlstm if kind == "m" else tx.init_slstm
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tp = init(torch.Generator().manual_seed(0), D, H, tdtype)
    assert sorted(tp) == sorted(jp)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape, name
        assert str(tp[name].dtype).removeprefix("torch.") == str(jp[name].dtype), name
    if kind == "m":
        assert tp["wif"].dtype == torch.float32
        assert torch.equal(tp["b_f"], torch.full((H,), 3.0))
        assert not tp["b_i"].any()
    else:
        assert tp["w_rec"].dtype == tp["bias"].dtype == torch.float32
        np.testing.assert_array_equal(tp["bias"].numpy(), np.asarray(jp["bias"]))


@pytest.mark.parametrize("with_state", [False, True])
def test_mlstm_scan_matches_jax(with_state):
    jp, tp = _params("m")
    x = _x((2, 13, D))
    state = None
    if with_state:   # the state after a first segment, from JAX
        _, state = jx.mlstm_scan(jp, jnp.asarray(_x((2, 5, D), seed=2)), H)
    want, jstate = jx.mlstm_scan(jp, jnp.asarray(x), H, init_state=state)
    tstate = None if state is None else tuple(torch.from_numpy(np.array(a)) for a in state)
    got, gstate = tx.mlstm_scan(tp, torch.from_numpy(x), H, init_state=tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close(gstate, jstate, **TOL)
    assert all(a.dtype == torch.float32 for a in gstate)


@pytest.mark.parametrize("s,chunk", [(70, 16), (64, 16), (300, 256)])
def test_mlstm_chunked_matches_jax(s, chunk):
    """70 and 300 pad the last chunk; the final state is the sequential
    form's ``(C, n, m)``."""
    jp, tp = _params("m")
    x = _x((2, s, D))
    want, jstate = jx.mlstm_chunked(jp, jnp.asarray(x), H, chunk=chunk)
    got, gstate = tx.mlstm_chunked(tp, torch.from_numpy(x), H, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close(gstate, jstate, **TOL)
    seq, sstate = tx.mlstm_scan(tp, torch.from_numpy(x), H)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), **CHUNK_TOL)
    _close(sstate[:2], gstate[:2], **CHUNK_TOL)


def test_mlstm_bf16_matches_jax():
    jp, tp = _params("m", dtype=jnp.bfloat16)
    x = jnp.asarray(_x((2, 40, D))).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    for j_fn, t_fn in ((jx.mlstm_scan, tx.mlstm_scan),
                       (lambda *a: jx.mlstm_chunked(*a, chunk=16),
                        lambda *a: tx.mlstm_chunked(*a, chunk=16))):
        want, jstate = j_fn(jp, x, H)
        got, gstate = t_fn(tp, xt, H)
        assert got.dtype == torch.bfloat16
        _close(got, want, **BF16_TOL)
        _close(gstate, jstate, **BF16_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_scan_matches_jax(with_state):
    jp, tp = _params("s")
    x = _x((2, 21, D))
    state = None
    if with_state:
        _, state = jx.slstm_scan(jp, jnp.asarray(_x((2, 4, D), seed=2)), H)
    want, jstate = jx.slstm_scan(jp, jnp.asarray(x), H, init_state=state)
    tstate = None if state is None else tuple(torch.from_numpy(np.array(a)) for a in state)
    got, gstate = tx.slstm_scan(tp, torch.from_numpy(x), H, init_state=tstate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close(gstate, jstate, **TOL)


def test_slstm_bf16_matches_jax():
    jp, tp = _params("s", dtype=jnp.bfloat16)
    x = jnp.asarray(_x((2, 24, D))).astype(jnp.bfloat16)
    want, jstate = jx.slstm_scan(jp, x, H)
    got, gstate = tx.slstm_scan(
        tp, torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16), H)
    _close(got, want, **BF16_TOL)
    _close(gstate, jstate, **BF16_TOL)


@pytest.mark.parametrize("kind", ["m", "s"])
def test_decode_steps_match_jax(kind):
    """Ten one-token steps from the initial state, each output and state
    against JAX's, and the last state against one scan over the ten."""
    jp, tp = _params(kind)
    j_step, t_step = ((jx.mlstm_decode_step, tx.mlstm_decode_step) if kind == "m"
                      else (jx.slstm_decode_step, tx.slstm_decode_step))
    j_scan, t_scan = (jx.mlstm_scan, tx.mlstm_scan) if kind == "m" else (jx.slstm_scan,
                                                                         tx.slstm_scan)
    x = _x((2, 10, D))
    _, jstate = j_scan(jp, jnp.asarray(x[:, :0]), H)   # the initial state
    tstate = tuple(torch.from_numpy(np.array(a)) for a in jstate)
    j_step = jax.jit(j_step, static_argnums=3)
    for t in range(10):
        want, jstate = j_step(jp, jnp.asarray(x[:, t:t + 1]), jstate, H)
        got, tstate = t_step(tp, torch.from_numpy(x[:, t:t + 1]), tstate, H)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {t}", **TOL)
        _close(tstate, jstate, **TOL)
    _, whole = t_scan(tp, torch.from_numpy(x), H)
    _close(tstate, tuple(a.numpy() for a in whole), **TOL)


def _grads_match(j_fn, t_fn, jp, tp, x):
    w = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    j_gp, j_gx = jax.jit(jax.grad(lambda p, a: jnp.sum(j_fn(p, a) * w), argnums=(0, 1)))(
        jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    (t_fn(live, xt) * torch.from_numpy(w)).sum().backward()
    for name, got, want in [("x", xt.grad, j_gx)] + [(n, live[n].grad, j_gp[n]) for n in jp]:
        want = np.asarray(want)
        assert bool(torch.isfinite(got).all()), name
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("s", [64, 70])
def test_mlstm_chunked_grads_with_long_gates_match_jax(s):
    """``tests/test_models_numerics.py:26``: inputs × 4 push the gates far
    out; every gradient is finite and JAX's."""
    jp, tp = _params("m", d=32, h=2)
    _grads_match(lambda p, a: jx.mlstm_chunked(p, a, 2, chunk=16)[0],
                 lambda p, a: tx.mlstm_chunked(p, a, 2, chunk=16)[0], jp, tp,
                 _x((1, s, 32), scale=4.0))


@pytest.mark.parametrize("kind", ["m", "s"])
def test_scan_grads_match_jax(kind):
    jp, tp = _params(kind, d=32, h=2)
    j_fn, t_fn = (jx.mlstm_scan, tx.mlstm_scan) if kind == "m" else (jx.slstm_scan,
                                                                    tx.slstm_scan)
    _grads_match(lambda p, a: j_fn(p, a, 2)[0], lambda p, a: t_fn(p, a, 2)[0], jp, tp,
                 _x((2, 12, 32), scale=2.0))
