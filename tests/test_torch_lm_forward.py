"""The port's full-sequence LM forward and loss against the JAX package,
on the CPU.

JAX's ``init_lm`` parameters are carried across by
``repro_torch.convert.lm_params_from_numpy``; tokens and activations are
drawn with numpy and handed to both packages.  Configs are the smoke
configs of ``chatglm3-6b`` (RMSNorm, GQA g = 2, partial RoPE) and
``stablelm-3b`` (LayerNorm, biases, g = 1), in float32.

Tolerances: attention functions f32 atol 1e-5 (``tests/test_kernels.py``'s
float32 tolerance), the chunked form against the full one in the port
atol 1e-5 as ``tests/test_models_numerics.py`` holds JAX's; ``forward``
logits, ``lm_loss`` and its gradients atol and rtol 1e-4 (XLA and torch
sum the matmuls in other orders); ``remat=True`` against ``remat=False``
bit for bit (the same ops recomputed); ``forward`` against the port's
``decode_step`` token by token atol 5e-4, rtol 5e-3
(``tests/test_archs_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as jattn
from repro.models import init_lm as j_init_lm
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import tree_map
from repro_torch.serve.decode import decode_step
from repro_torch.serve.kvcache import init_cache

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)
ARCHS = ["chatglm3-6b", "stablelm-3b"]


def _tree_pairs(a, b, path="root"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in sorted(a):
            yield from _tree_pairs(a[k], b[k], f"{path}.{k}")
    else:
        yield path, a, b


def _attn_case(arch, s, b=2, seed=0):
    cfg = j_get_config(arch, smoke=True)
    hd = cfg.resolved_head_dim
    p = jattn.init_attention(jax.random.PRNGKey(seed), cfg.d_model, cfg.num_heads,
                             cfg.kv_heads, hd, jnp.float32, use_bias=cfg.use_bias)
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)).astype(np.float32)
    kw = dict(num_heads=cfg.num_heads, kv_heads=cfg.kv_heads, head_dim=hd,
              rope_partial=cfg.rope_2d)
    return p, lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu"), x, kw


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 5])
def test_self_attention_matches_jax(arch, window):
    jp, tp, x, kw = _attn_case(arch, 16)
    want = jattn.self_attention(jp, jnp.asarray(x), window=window, **kw)
    got = tattn.self_attention(tp, torch.from_numpy(x), window=window, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [0, 12])
def test_chunked_self_attention_matches_jax_and_full(arch, window):
    jp, tp, x, kw = _attn_case(arch, 32)
    chunks = dict(q_chunk=8, k_chunk=4)
    want = jattn.chunked_self_attention(jp, jnp.asarray(x), window=window, **chunks, **kw)
    got = tattn.chunked_self_attention(tp, torch.from_numpy(x), window=window, **chunks, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    full = tattn.self_attention(tp, torch.from_numpy(x), window=window, **kw)
    np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)


def test_chunked_self_attention_grads_match_full_and_reject_ragged_chunks():
    _, tp, x, kw = _attn_case("chatglm3-6b", 16, b=1)
    xs = [torch.from_numpy(x).requires_grad_(True) for _ in range(2)]
    tattn.chunked_self_attention(tp, xs[0], q_chunk=4, k_chunk=8, **kw).square().sum().backward()
    tattn.self_attention(tp, xs[1], **kw).square().sum().backward()
    np.testing.assert_allclose(xs[0].grad.numpy(), xs[1].grad.numpy(), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        tattn.chunked_self_attention(tp, torch.from_numpy(x), q_chunk=5, k_chunk=4, **kw)


def _lm_case(arch, b=2, s=12, seed=0):
    j_cfg, cfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    j_params = j_init_lm(jax.random.PRNGKey(seed), j_cfg)
    t_params = lm_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu")
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s + 1))
    toks = toks.astype(np.int32)
    return j_cfg, cfg, j_params, t_params, toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_lm_loss_match_jax(arch):
    j_cfg, cfg, jp, tp, tokens, labels = _lm_case(arch)
    want, want_aux = jtf.forward(jp, j_cfg, jnp.asarray(tokens))
    got, aux = ttf.forward(tp, cfg, torch.from_numpy(tokens))
    assert got.shape == (2, 12, cfg.padded_vocab) and float(aux) == float(want_aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP_TOL)
    j_loss = jtf.lm_loss(jp, j_cfg, jnp.asarray(tokens), jnp.asarray(labels))
    t_loss = ttf.lm_loss(tp, cfg, torch.from_numpy(tokens), torch.from_numpy(labels))
    assert t_loss.dtype == torch.float32
    np.testing.assert_allclose(float(t_loss), float(j_loss), **STEP_TOL)


def test_lm_loss_masks_the_padded_vocab_tail():
    """A vocab of 200 pads to 256: the tail's logits never enter the
    normalizer, in either package."""
    j_cfg = dataclasses.replace(j_get_config("chatglm3-6b", smoke=True), vocab_size=200)
    cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True), vocab_size=200)
    assert cfg.padded_vocab == 256
    jp = j_init_lm(jax.random.PRNGKey(3), j_cfg)
    jp["lm_head"] = jp["lm_head"].at[:, 200:].set(50.0)   # large tail logits
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(3).integers(0, 200, size=(2, 9)).astype(np.int32)
    want = jtf.lm_loss(jp, j_cfg, jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    got = ttf.lm_loss(tp, cfg, torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:]))
    np.testing.assert_allclose(float(got), float(want), **STEP_TOL)
    assert float(got) < 10.0


def _port_grads(tp, cfg, tokens, labels, remat):
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss = ttf.lm_loss(live, cfg, torch.from_numpy(tokens), torch.from_numpy(labels),
                       remat=remat)
    loss.backward()
    return loss.detach(), tree_map(lambda t: t.grad, live)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grads_match_jax_grad_and_remat(arch):
    j_cfg, cfg, jp, tp, tokens, labels = _lm_case(arch, seed=1)
    j_grads = jax.grad(jtf.lm_loss)(jp, j_cfg, jnp.asarray(tokens), jnp.asarray(labels))
    loss, grads = _port_grads(tp, cfg, tokens, labels, remat=False)
    for path, g, j in _tree_pairs(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=path, **STEP_TOL)
    loss_r, grads_r = _port_grads(tp, cfg, tokens, labels, remat=True)
    assert float(loss_r) == float(loss)
    for path, a, b in _tree_pairs(grads_r, grads):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)


def test_forward_takes_the_chunked_path_at_the_threshold(monkeypatch):
    """At ``CHUNKED_ATTN_THRESHOLD`` tokens every block runs the chunked
    attention; its logits equal the full attention's within f32."""
    _, cfg, _, tp, _, _ = _lm_case("chatglm3-6b")
    monkeypatch.setattr(ttf, "CHUNKED_ATTN_THRESHOLD", 16)
    calls = []
    chunked = tattn.chunked_self_attention

    def spy(*a, **kw):
        calls.append(1)
        return chunked(*a, q_chunk=8, k_chunk=8, **kw)

    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(1, 16)).astype(np.int32))
    want, _ = ttf.forward(tp, cfg, toks[:, :15])                  # below: full attention
    monkeypatch.setattr(tattn, "chunked_self_attention", spy)
    got, _ = ttf.forward(tp, cfg, toks)
    assert len(calls) == cfg.num_layers
    np.testing.assert_allclose(got[:, :15].numpy(), want.numpy(), **STEP_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_agrees_with_decode_step(arch):
    _, cfg, _, tp, tokens, _ = _lm_case(arch, b=2, s=10, seed=2)
    full, _ = ttf.forward(tp, cfg, torch.from_numpy(tokens))
    cache = init_cache(cfg, 2, 16, device="cpu")
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            step, _ = decode_step(tp, cfg, torch.from_numpy(tokens[:, t:t + 1]), cache)
            np.testing.assert_allclose(step[:, 0].numpy(), full[:, t].detach().numpy(),
                                       err_msg=f"token {t}", **DECODE_TOL)


def test_other_families_raise():
    """A family neither package has raises ``ValueError`` in ``forward``
    and ``lm_loss``, as JAX's ``forward`` does.  The recurrent families
    (ssm, hybrid), which raised until their slice, now compute JAX's
    logits and loss."""
    toks = np.random.default_rng(0).integers(0, 256, size=(1, 4)).astype(np.int32)
    t_toks = torch.from_numpy(toks)
    _, cfg, jp, tp, _, _ = _lm_case("chatglm3-6b", b=1, s=4)
    other = dataclasses.replace(cfg, family="recsys")
    with pytest.raises(ValueError, match="unknown family"):
        ttf.forward(tp, other, t_toks)
    with pytest.raises(ValueError, match="unknown family"):
        ttf.lm_loss(tp, other, t_toks, t_toks)
    with pytest.raises(ValueError, match="unknown family"):
        jtf.forward(jp, dataclasses.replace(j_get_config("chatglm3-6b", smoke=True),
                                            family="recsys"), jnp.asarray(toks))
    for arch in ("xlstm-125m", "zamba2-7b"):
        j_cfg, cfg, jp, tp, _, _ = _lm_case(arch, b=1, s=4)
        want, _ = jtf.forward(jp, j_cfg, jnp.asarray(toks))
        got, _ = ttf.forward(tp, cfg, t_toks)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **STEP_TOL)
        np.testing.assert_allclose(float(ttf.lm_loss(tp, cfg, t_toks, t_toks)),
                                   float(jtf.lm_loss(jp, j_cfg, toks, toks)), **STEP_TOL)
