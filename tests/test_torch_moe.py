"""The port's Mixture-of-Experts layer against the JAX package, on the CPU.

``init_moe`` parameters drawn by JAX are carried across by
``repro_torch.convert.lm_params_from_numpy``; tokens are drawn with
numpy.  The layer is ``granite-moe-3b-a800m``'s smoke config (8 experts,
top-2, d_model 64, d_ff 64) at 128 tokens, where a capacity factor of
0.25 drops choices and one of ``num_experts`` drops none.

Tolerances: float32 ``y`` and ``aux`` atol 1e-5 (``tests/test_kernels.py``'s
float32 tolerance); bfloat16 ``y`` atol 0.15, rtol 1e-2
(``tests/test_kernels.py:34``); they are not bit-equal on the CPU
(16-59 % of the elements differ, by a bf16 ulp or two, at 128 tokens:
XLA's and torch's bf16 expert matmuls round differently); ``moe_flops_per_token``
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import tree_map

ARCH = "granite-moe-3b-a800m"
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=0.15, rtol=1e-2)


def _case(act="swiglu", cf=0.25, b=4, s=32, dtype=jnp.float32, seed=0):
    cfg = j_get_config(ARCH, smoke=True)
    moe = dataclasses.replace(cfg.moe, capacity_factor=cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), cfg.d_model, cfg.d_ff, moe, act, dtype)
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tx = lm_params_from_numpy({"x": np.asarray(jx)}, "cpu")["x"]
    return moe, jp, jx, tp, tx


def _both(act, cf, num_groups, **kw):
    moe, jp, jx, tp, tx = _case(act, cf, **kw)
    want = jmoe.apply_moe(jp, jx, moe, act, num_groups=num_groups)
    got = tmoe.apply_moe(tp, tx, moe, act, num_groups=num_groups)
    return got, want


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("num_groups", [1, 2, 5])   # 5 does not divide 128: one group
@pytest.mark.parametrize("cf", [0.25, 8.0], ids=["drops", "drop-free"])
def test_apply_moe_matches_jax(act, num_groups, cf):
    (y, aux), (jy, jaux) = _both(act, cf, num_groups)
    assert y.shape == (4, 32, 64) and y.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_capacity_drops_change_the_output_and_groups_fall_back():
    """At cf 0.25 choices drop (the output differs from the drop-free
    one); a ``num_groups`` that does not divide T is one group."""
    (y_drop, _), _ = _both("swiglu", 0.25, 1)
    (y_free, _), _ = _both("swiglu", 8.0, 1)
    assert not torch.allclose(y_drop, y_free, atol=1e-3)
    (y5, _), _ = _both("swiglu", 0.25, 5)
    assert torch.equal(y5, y_drop)
    (y2, _), _ = _both("swiglu", 0.25, 2)
    assert not torch.equal(y2, y_drop)   # group-local capacity drops other choices


@pytest.mark.parametrize("num_groups", [1, 2])
@pytest.mark.parametrize("cf", [0.25, 8.0], ids=["drops", "drop-free"])
def test_apply_moe_bf16_matches_jax(num_groups, cf):
    (y, aux), (jy, jaux) = _both("swiglu", cf, num_groups, dtype=jnp.bfloat16)
    assert y.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    np.testing.assert_allclose(y.float().numpy(), want, **BF16_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_apply_moe_grads_match_jax():
    moe, jp, jx, tp, tx = _case(cf=0.25, b=2, s=32, seed=1)
    w = np.random.default_rng(1).normal(size=jx.shape).astype(np.float32)

    def j_loss(p, x):
        y, aux = jmoe.apply_moe(p, x, moe, "swiglu", num_groups=2)
        return jnp.sum(y * w) + aux

    jg_p, jg_x = jax.grad(j_loss, argnums=(0, 1))(jp, jx)
    live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    xl = tx.clone().requires_grad_(True)
    y, aux = tmoe.apply_moe(live, xl, moe, "swiglu", num_groups=2)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    np.testing.assert_allclose(xl.grad.numpy(), np.asarray(jg_x), atol=1e-4, rtol=1e-4)
    for name in jp:
        np.testing.assert_allclose(live[name].grad.numpy(), np.asarray(jg_p[name]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_shardmap_impl_outside_a_mesh_is_apply_moe():
    moe, jp, jx, tp, tx = _case(cf=0.25)
    jy, jaux = jmoe.apply_moe_shardmap(jp, jx, moe, "swiglu")
    y, aux = tmoe.apply_moe_shardmap(tp, tx, moe, "swiglu")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    y1, _ = tmoe.apply_moe(tp, tx, moe, "swiglu")
    assert torch.equal(y, y1)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_init_moe_tree_and_flops_match_jax(act):
    cfg, t_cfg = j_get_config(ARCH), get_config(ARCH)
    small = dataclasses.replace(cfg.moe, num_experts=4)
    jp = jmoe.init_moe(jax.random.PRNGKey(0), 32, 48, small, act, jnp.bfloat16)
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), 32, 48, small, act, torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).removeprefix("torch.") == str(jp[k].dtype), k
    assert tp["router"].dtype == torch.float32
    for d, f in ((cfg.d_model, cfg.d_ff), (64, 128)):
        assert (tmoe.moe_flops_per_token(d, f, t_cfg.moe, act)
                == jmoe.moe_flops_per_token(d, f, cfg.moe, act))
