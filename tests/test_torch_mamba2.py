"""The port's Mamba2 block against the JAX package, on the CPU: the
``init_mamba2`` tree, the causal conv, ``mamba2_scan`` (sequences that
are not a multiple of the chunk, from a carried state), the one-token
recurrence with its states, the gradients of ``apply_mamba2`` under long
gates, and ``softplus``.

JAX's parameters are carried across by ``repro_torch.convert``; inputs
are drawn with numpy.  Tolerances: float32 outputs and states atol 1e-5
(rtol 1e-5), the chunked form against the recurrence 2e-5 as
``tests/test_models_numerics.py:50`` holds it; bfloat16 atol 0.15, rtol
1e-2; gradients rtol 1e-4 and atol 1e-4 × max(1, the leaf's largest
|gradient|) (XLA and torch sum the float32 products in other orders).
``F.softplus(x, threshold=20)`` returns ``x`` past 20 where JAX computes
``logaddexp(x, 0)``: within 1 float32 ulp of each other (rtol 2.4e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import mamba2 as jm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import mamba2 as tm
from repro_torch.models.layers import tree_map

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.15, rtol=1e-2)
GRAD_RTOL = 1e-4
D, N, HD = 48, 16, 32        # d_inner 96: 3 heads of 32


def _params(d=D, n=N, hd=HD, dtype=jnp.float32, seed=0):
    jp = jm.init_mamba2(jax.random.PRNGKey(seed), d, n, dtype, head_dim=hd)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, scale=0.5, seed=1):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_init_tree_matches_jax(dtype):
    jp, _ = _params(dtype=dtype)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tp = tm.init_mamba2(torch.Generator().manual_seed(0), D, N, tdtype, head_dim=HD)
    assert sorted(tp) == sorted(jp)
    for name in jp:
        assert tuple(tp[name].shape) == jp[name].shape, name
        assert str(tp[name].dtype).removeprefix("torch.") == str(jp[name].dtype), name
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]), atol=1e-6)
    for name in ("D", "dt_bias", "norm_scale"):
        np.testing.assert_array_equal(tp[name].float().numpy(),
                                      np.asarray(jp[name], np.float32), err_msg=name)
    assert tm.CONV_W == jm.CONV_W == 4


def test_zamba2_full_widths():
    """``head_dim`` 64 at zamba2-7b FULL: d_inner 7,168 and 112 heads."""
    tp = tm.init_mamba2(torch.Generator().manual_seed(0), 3584, 64, torch.bfloat16)
    assert tuple(tp["w_in"].shape) == (3584, 2 * 7168 + 2 * 64 + 112)
    assert tuple(tp["A_log"].shape) == (112,) and tuple(tp["conv"].shape) == (4, 7168)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_causal_conv_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(2, 7, 96)).astype(np.float32)).astype(dtype)
    w = jnp.asarray(rng.normal(size=(4, 96)).astype(np.float32)).astype(dtype)
    st = jnp.asarray(rng.normal(size=(2, 3, 96)).astype(np.float32)).astype(dtype)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tt = lambda a: _t(a.astype(jnp.float32)).to(tdtype)
    for state in (None, st):
        want, wst = jm._causal_conv(x, w, state)
        got, gst = tm._causal_conv(tt(x), tt(w), None if state is None else tt(state))
        assert got.dtype == tdtype
        _close(got, want, **(TOL if dtype == jnp.float32 else BF16_TOL))
        np.testing.assert_array_equal(gst.float().numpy(), np.asarray(wst, np.float32))


@pytest.mark.parametrize("s,chunk", [(33, 8), (32, 8), (200, 128)])
def test_mamba2_scan_matches_jax(s, chunk):
    """33 and 200 pad the last chunk; the final SSM and conv states too."""
    jp, tp = _params()
    u = _x((2, s, D))
    want, (jh, jc) = jm.mamba2_scan(jp, jnp.asarray(u), ssm_state=N, head_dim=HD, chunk=chunk)
    got, (gh, gc) = tm.mamba2_scan(tp, torch.from_numpy(u), ssm_state=N, head_dim=HD,
                                   chunk=chunk)
    _close(got, want, **TOL)
    _close(gh, jh, **TOL)
    _close(gc, jc, **TOL)
    assert gh.dtype == torch.float32


def test_mamba2_scan_from_a_carried_state_matches_jax():
    jp, tp = _params()
    _, (h0, c0) = jm.mamba2_scan(jp, jnp.asarray(_x((2, 9, D), seed=2)), ssm_state=N,
                                 head_dim=HD, chunk=8)
    u = _x((2, 13, D))
    want, (jh, jc) = jm.mamba2_scan(jp, jnp.asarray(u), ssm_state=N, head_dim=HD, chunk=8,
                                    init_state=h0, conv_state=c0)
    got, (gh, gc) = tm.mamba2_scan(tp, torch.from_numpy(u), ssm_state=N, head_dim=HD, chunk=8,
                                   init_state=_t(h0), conv_state=_t(c0))
    _close(got, want, **TOL)
    _close(gh, jh, **TOL)
    _close(gc, jc, **TOL)


def test_mamba2_bf16_matches_jax():
    jp, tp = _params(dtype=jnp.bfloat16)
    u = jnp.asarray(_x((2, 40, D))).astype(jnp.bfloat16)
    ut = _t(u.astype(jnp.float32)).to(torch.bfloat16)
    want, (jh, _) = jm.mamba2_scan(jp, u, ssm_state=N, head_dim=HD, chunk=16)
    got, (gh, _) = tm.mamba2_scan(tp, ut, ssm_state=N, head_dim=HD, chunk=16)
    assert got.dtype == torch.bfloat16 and gh.dtype == torch.float32
    _close(got, want, **BF16_TOL)
    _close(gh, jh, **BF16_TOL)
    state = torch.zeros((2, 3, HD, N))
    conv = torch.zeros((2, 3, 2 * D), dtype=torch.bfloat16)
    jstate, jconv = jnp.zeros((2, 3, HD, N)), jnp.zeros((2, 3, 2 * D), jnp.bfloat16)
    for t in range(3):
        want, jstate, jconv = jm.mamba2_decode_step(jp, u[:, t:t + 1], jstate, jconv,
                                                    ssm_state=N, head_dim=HD)
        got, state, conv = tm.mamba2_decode_step(tp, ut[:, t:t + 1], state, conv,
                                                 ssm_state=N, head_dim=HD)
        _close(got, want, **BF16_TOL)
        _close(state, jstate, **BF16_TOL)


def test_decode_steps_match_jax_and_the_scan():
    """Twelve one-token steps, each output and state against JAX's; the
    outputs and last state against the chunked form over the twelve."""
    jp, tp = _params()
    b, s = 2, 12
    u = _x((b, s, D))
    jstate, jconv = jnp.zeros((b, 3, HD, N)), jnp.zeros((b, tm.CONV_W - 1, 2 * D))
    state, conv = torch.zeros((b, 3, HD, N)), torch.zeros((b, tm.CONV_W - 1, 2 * D))
    step = jax.jit(lambda a, h, c: jm.mamba2_decode_step(jp, a, h, c, ssm_state=N, head_dim=HD))
    ys = []
    for t in range(s):
        want, jstate, jconv = step(jnp.asarray(u[:, t:t + 1]), jstate, jconv)
        got, state, conv = tm.mamba2_decode_step(tp, torch.from_numpy(u[:, t:t + 1]), state,
                                                 conv, ssm_state=N, head_dim=HD)
        _close(got, want, **TOL)
        _close(state, jstate, **TOL)
        _close(conv, jconv, **TOL)
        ys.append(got)
    whole, (h, c) = tm.mamba2_scan(tp, torch.from_numpy(u), ssm_state=N, head_dim=HD, chunk=8)
    _close(torch.cat(ys, dim=1), whole.numpy(), **STEP_TOL)
    _close(state, h.numpy(), **TOL)
    _close(conv, c.numpy(), **TOL)


@pytest.mark.parametrize("scale", [1.0, 4.0])
def test_apply_mamba2_grads_match_jax(scale):
    """``tests/test_models_numerics.py:53``, and inputs × 4 (large ``dt``,
    decays far below 1): every gradient finite and JAX's."""
    jp, tp = _params(d=32, n=8, hd=16)
    u = _x((2, 24, 32), scale=scale)
    kw = dict(ssm_state=8, head_dim=16, chunk=8)
    w = np.random.default_rng(3).normal(size=u.shape).astype(np.float32)
    j_gp, j_gu = jax.jit(jax.grad(lambda p, a: jnp.sum(jm.apply_mamba2(p, a, **kw) * w),
                                  argnums=(0, 1)))(jp, jnp.asarray(u))
    ut = torch.from_numpy(u).requires_grad_(True)
    live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    (tm.apply_mamba2(live, ut, **kw) * torch.from_numpy(w)).sum().backward()
    for name, got, want in [("u", ut.grad, j_gu)] + [(n, live[n].grad, j_gp[n]) for n in jp]:
        want = np.asarray(want)
        assert bool(torch.isfinite(got).all()), name
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * max(1.0, float(np.abs(want).max())))


def test_softplus_within_an_ulp_of_jax():
    x = np.concatenate([np.linspace(-40, 40, 4001), [19.99, 20.0, 20.01, 25.0, 90.0]])
    x = x.astype(np.float32)
    got = F.softplus(torch.from_numpy(x), beta=1, threshold=20).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
