"""The moe, vlm and audio LM families and the two remaining dense configs
of the port against the JAX package, on the CPU: configs, the parameter
tree, gated cross-attention, ``forward``, ``lm_loss`` and its gradients.

JAX's ``init_lm`` parameters are carried across by
``repro_torch.convert.lm_params_from_numpy``; tokens and image
embeddings are drawn with numpy and handed to both packages.  Configs are
the smoke configs of ``granite-moe-3b-a800m`` and ``grok-1-314b`` (moe),
``llama-3.2-vision-11b`` (vlm: one superblock of 4 self + 1 cross
block), ``musicgen-medium`` (audio: 2 codebooks, LayerNorm, GELU,
biases), ``minicpm-2b`` (tied embeddings) and ``command-r-35b``
(LayerNorm, rope_theta 8e6), in float32.  The vlm cross-attention gate is
zero at init, which would hide the cross path: the tests set it to 0.5
on both sides, and the image embeddings are N(0, 0.1²) as
``tests/test_archs_smoke.py`` draws them.

Tolerances are ``tests/test_torch_lm_forward.py``'s: attention functions
f32 atol 1e-5 (their gradients 1e-4), ``forward`` logits, ``lm_loss``
and its gradients atol and rtol 1e-4 (XLA and torch sum the matmuls in
other orders); ``remat=True`` against ``remat=False`` bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import init_lm as j_init_lm
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import base as t_base
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import tree_map

from _torch_lm_families_cases import GATE, _j, _t, _tree_pairs, lm_case

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["granite-moe-3b-a800m", "grok-1-314b", "llama-3.2-vision-11b", "musicgen-medium",
         "minicpm-2b", "command-r-35b"]


# ------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_jax(arch, smoke):
    t_cfg, j_cfg = get_config(arch, smoke=smoke), j_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.param_count() == j_cfg.param_count()
    assert t_cfg.active_param_count() == j_cfg.active_param_count()
    assert t_cfg.padded_vocab == j_cfg.padded_vocab
    assert t_base.supported_shapes(t_cfg) == j_base.supported_shapes(j_cfg)


def test_registry_has_the_new_configs_and_refuses_ssm_and_hybrid():
    """The ssm and hybrid configs, refused until their slice, are now in
    the registry and equal JAX's; the registry is the reference's."""
    assert set(ARCHS) <= set(list_configs())
    assert list_configs() == j_base.list_configs()
    for arch in ("xlstm-125m", "zamba2-7b"):
        assert dataclasses.asdict(get_config(arch, smoke=True)) == dataclasses.asdict(
            j_get_config(arch, smoke=True))


# ----------------------------------------------------- cross-attention --

def _cross_case(s, b=2, t=24, seed=0):
    cfg = j_get_config("llama-3.2-vision-11b", smoke=True)
    hd = cfg.resolved_head_dim
    p = jattn.init_cross_attention(jax.random.PRNGKey(seed), cfg.d_model, cfg.num_heads,
                                   cfg.kv_heads, hd, cfg.d_model, jnp.float32)
    p = dict(p, gate=jnp.full((1,), GATE, jnp.float32))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    enc = (rng.normal(size=(b, t, cfg.d_model)) * 0.1).astype(np.float32)
    kw = dict(num_heads=cfg.num_heads, kv_heads=cfg.kv_heads, head_dim=hd)
    return p, lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu"), x, enc, kw


@pytest.mark.parametrize("s", [16, 1024])   # 1024: two query chunks of 512
def test_cross_attention_and_its_grads_match_jax(s):
    jp, tp, x, enc, kw = _cross_case(s)
    want = jattn.cross_attention(jp, jnp.asarray(x), jnp.asarray(enc), **kw)
    xt = torch.from_numpy(x).requires_grad_(True)
    et = torch.from_numpy(enc).requires_grad_(True)
    live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    got = tattn.cross_attention(live, xt, et, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    assert float(got.detach().abs().max()) > 1e-3   # the open gate lets the path through

    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    j_gp, j_gx, j_ge = jax.grad(
        lambda p, a, e: jnp.sum(jattn.cross_attention(p, a, e, **kw) * w),
        argnums=(0, 1, 2))(jp, jnp.asarray(x), jnp.asarray(enc))
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(j_gx), **STEP_TOL)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(j_ge), **STEP_TOL)
    for name in jp:
        np.testing.assert_allclose(live[name].grad.numpy(), np.asarray(j_gp[name]),
                                   err_msg=name, **STEP_TOL)


def test_cross_attention_chunks_only_at_a_multiple_of_the_chunk(monkeypatch):
    calls = []
    real = tattn._cross_block
    monkeypatch.setattr(tattn, "_cross_block", lambda *a: calls.append(a[0].shape[1]) or real(*a))
    for s, want in ((1024, [512, 512]), (512, [512]), (600, [600])):
        calls.clear()
        _, tp, x, enc, kw = _cross_case(s, b=1, t=8)
        with torch.no_grad():
            tattn.cross_attention(tp, torch.from_numpy(x), torch.from_numpy(enc), **kw)
        assert calls == want, s


# ------------------------------------------------------------ init_lm --

@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_matches_jax(arch):
    cfg, j_cfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    j_params = j_init_lm(jax.random.PRNGKey(0), j_cfg)
    t_params = ttf.init_lm(torch.Generator().manual_seed(0), cfg)
    for path, t, j in _tree_pairs(t_params, j_params):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
    assert tlayers.count_params(t_params) == jlayers.count_params(j_params)
    converted = lm_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu")
    for path, c, j in _tree_pairs(converted, j_params):
        np.testing.assert_array_equal(c.numpy(), np.asarray(j), err_msg=path)
    if cfg.family == "vlm":
        assert t_params["layers"]["super"]["attn"]["wq"].shape[:2] == (1, 4)
        assert t_params["layers"]["cross"]["xattn"]["gate"].shape == (1, 1)
        assert not t_params["layers"]["cross"]["xattn"]["gate"].any()   # zero at init


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama-3.2-vision-11b",
                                  "musicgen-medium"])
def test_init_lm_bf16_converts_bit_for_bit(arch):
    cfg = dataclasses.replace(j_get_config(arch, smoke=True), dtype="bfloat16")
    j_params = j_init_lm(jax.random.PRNGKey(0), cfg)
    t = lm_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu")
    for path, a, j in _tree_pairs(t, j_params):
        assert str(a.dtype).removeprefix("torch.") == str(j.dtype), path
        if a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          np.asarray(j).view(np.int16), err_msg=path)
        else:   # the moe router stays float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(j), err_msg=path)


# ------------------------------------------------------------ forward --

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_lm_loss_match_jax(arch):
    j_cfg, cfg, jp, tp, tokens, labels, enc = lm_case(arch)
    want, want_aux = jtf.forward(jp, j_cfg, jnp.asarray(tokens), enc=_j(enc))
    got, aux = ttf.forward(tp, cfg, torch.from_numpy(tokens), enc=_t(enc))
    lead = (2, cfg.num_codebooks) if cfg.family == "audio" else (2,)
    assert got.shape == (*lead, 12, cfg.padded_vocab) and aux.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **STEP_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **STEP_TOL)
    assert (float(aux) > 0) == (cfg.family == "moe")
    j_loss = jtf.lm_loss(jp, j_cfg, jnp.asarray(tokens), jnp.asarray(labels), enc=_j(enc))
    t_loss = ttf.lm_loss(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(labels),
                         enc=_t(enc))
    np.testing.assert_allclose(float(t_loss), float(j_loss), **STEP_TOL)


def test_vlm_forward_needs_enc_and_sees_it():
    _, cfg, _, tp, tokens, _, enc = lm_case("llama-3.2-vision-11b")
    with pytest.raises(ValueError, match="enc"):
        ttf.forward(tp, cfg, torch.from_numpy(tokens))
    with torch.no_grad():
        a, _ = ttf.forward(tp, cfg, torch.from_numpy(tokens), enc=torch.from_numpy(enc))
        b, _ = ttf.forward(tp, cfg, torch.from_numpy(tokens), enc=torch.zeros_like(
            torch.from_numpy(enc)))
    assert not torch.allclose(a, b, atol=1e-4)


def _port_grads(tp, cfg, tokens, labels, enc, remat):
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss = ttf.lm_loss(live, cfg, torch.from_numpy(tokens), torch.from_numpy(labels),
                       enc=_t(enc), remat=remat)
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, live)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grads_match_jax_grad_and_remat(arch):
    j_cfg, cfg, jp, tp, tokens, labels, enc = lm_case(arch, seed=1)
    j_grads = jax.grad(jtf.lm_loss)(jp, j_cfg, jnp.asarray(tokens), jnp.asarray(labels),
                                    enc=_j(enc))
    loss, grads = _port_grads(tp, cfg, tokens, labels, enc, remat=False)
    for path, g, j in _tree_pairs(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=path, **STEP_TOL)
    loss_r, grads_r = _port_grads(tp, cfg, tokens, labels, enc, remat=True)
    assert float(loss_r) == float(loss)
    for path, a, b in _tree_pairs(grads_r, grads):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)


@pytest.mark.parametrize("groups,impl", [(2, "gspmd"), (1, "shardmap")])
def test_moe_forward_with_groups_and_shardmap_impl_matches_jax(groups, impl):
    """``moe_groups`` reaches ``apply_moe`` in the forward; ``moe_impl=
    "shardmap"`` outside a mesh is ``apply_moe`` without groups."""
    j_cfg, cfg, jp, tp, tokens, labels, _ = lm_case(
        "granite-moe-3b-a800m", b=4, s=16, cfg_overrides=dict(moe_groups=groups,
                                                              moe_impl=impl))
    want, want_aux = jtf.forward(jp, j_cfg, jnp.asarray(tokens))
    got, aux = ttf.forward(tp, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **STEP_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **STEP_TOL)
