"""LM decode serving of the port against the JAX package, on the CPU.

JAX's ``init_lm`` parameters are carried across by
``repro_torch.convert.lm_params_from_numpy``; other inputs are drawn
with numpy and handed to both packages.  Configs are the smoke configs
of ``chatglm3-6b`` (RMSNorm, GQA g = 2, partial RoPE) and ``stablelm-3b``
(LayerNorm, biases, g = 1), in float32.  The port's int8 attention runs
the flash-decode kernel's plain version (CPU tensors).

Tolerances: layer functions f32 atol 1e-5; ``decode_step`` logits atol
and rtol 1e-4 over 8 steps (XLA and torch sum the matmuls in other
orders, and the error compounds over layers and steps); int8 cache
entries within 1 of JAX's with at least 99 % equal (a value on a rounding
boundary can flip), scales within one bf16 ulp.
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
from repro.models import rope as jrope
from repro.serve import batching as j_batching
from repro.serve import decode as jdecode
from repro.serve import kvcache as jkv
from repro_torch.configs import base as t_base
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import _tensor, cache_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope
from repro_torch.models.transformer import init_lm
from repro_torch.serve.batching import Request, RequestBatcher
from repro_torch.serve.decode import decode_step
from repro_torch.serve.kvcache import cache_bytes, init_cache

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["chatglm3-6b", "stablelm-3b"]


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


def _tree_pairs(a, b, path="root"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in sorted(a):
            yield from _tree_pairs(a[k], b[k], f"{path}.{k}")
    else:
        yield path, a, b


# ------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_jax(arch, smoke):
    t_cfg, j_cfg = get_config(arch, smoke=smoke), j_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.param_count() == j_cfg.param_count()
    assert t_cfg.padded_vocab == j_cfg.padded_vocab
    assert t_cfg.q_per_kv == j_cfg.q_per_kv
    assert t_cfg.torch_dtype == {"bfloat16": torch.bfloat16, "float32": torch.float32}[j_cfg.dtype]
    assert t_base.supported_shapes(t_cfg) == j_base.supported_shapes(j_cfg)


def test_registry():
    assert {"chatglm3-6b", "stablelm-3b", "dlrm-recross"} <= set(list_configs())
    assert list_configs() == j_base.list_configs()
    assert get_config("dlrm-recross", smoke=True).name == "dlrm-recross"
    assert {k: dataclasses.asdict(v) for k, v in t_base.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_base.SHAPES.items()}
    for arch in ("xlstm-125m", "zamba2-7b"):    # ssm and hybrid, ported with their slice
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    with pytest.raises(KeyError):
        get_config("no-such-model")


# -------------------------------------------------------------- layers --

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=64).astype(np.float32)
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_mlp_matches_jax(act):
    p = jlayers.init_mlp(jax.random.PRNGKey(1), 64, 192, act, jnp.float32, use_bias=True)
    x = np.random.default_rng(1).normal(size=(2, 3, 64)).astype(np.float32)
    want = jlayers.apply_mlp(p, jnp.asarray(x), act)
    got = tlayers.apply_mlp(lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu"),
                            torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("partial", [False, True])
def test_apply_rope_matches_jax(partial):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=10_000.0, partial=partial)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=10_000.0,
                           partial=partial)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if partial:
        np.testing.assert_array_equal(got[..., 8:].numpy(), x[..., 8:])


def test_layer_tree_helpers():
    p = {"a": torch.ones(3, 2), "b": {"c": torch.zeros(3, 4, dtype=torch.int32)}}
    s = tlayers.layer_slice(tlayers.stack_layers([p, p]), 1)
    assert s["a"].shape == (3, 2) and s["b"]["c"].dtype == torch.int32
    assert tlayers.count_params(p) == 18
    cast = tlayers.cast_floats(p, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"]["c"].dtype == torch.int32


# ----------------------------------------------------------- attention --

def _attn_case(arch, quant, length=5, b=2, S=16, seed=3):
    cfg = j_get_config(arch, smoke=True)
    hd = cfg.resolved_head_dim
    p = jattn.init_attention(jax.random.PRNGKey(seed), cfg.d_model, cfg.num_heads,
                             cfg.kv_heads, hd, jnp.float32, use_bias=cfg.use_bias)
    if cfg.use_bias:  # zero at init: make the bias path visible
        rng_b = np.random.default_rng(seed + 1)
        p = dict(p, **{k: jnp.asarray(rng_b.normal(size=p[k].shape).astype(np.float32))
                       for k in ("bq", "bk", "bv")})
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
    shape = (b, S, cfg.kv_heads, hd)
    if quant:
        k = rng.integers(-127, 128, size=shape).astype(np.int8)
        v = rng.integers(-127, 128, size=shape).astype(np.int8)
        ks = np.asarray(jnp.asarray(rng.uniform(0.001, 0.02, size=shape[:-1]), jnp.bfloat16))
        vs = np.asarray(jnp.asarray(rng.uniform(0.001, 0.02, size=shape[:-1]), jnp.bfloat16))
        caches = (k, v, ks, vs)
    else:
        caches = tuple(rng.normal(size=shape).astype(np.float32) for _ in range(2))
    kw = dict(num_heads=cfg.num_heads, kv_heads=cfg.kv_heads, head_dim=hd,
              rope_theta=cfg.rope_theta, rope_partial=cfg.rope_2d)
    return p, x, caches, length, kw


@pytest.mark.parametrize("length", [0, 5, 16])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_attention_readonly_matches_jax(arch, quant, length):
    p, x, caches, length, kw = _attn_case(arch, quant, length)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    jc = [jnp.asarray(c) for c in caches]
    tc = [_tensor(c, "cpu") for c in caches]
    jl, tl = jnp.asarray(length, jnp.int32), torch.tensor(length, dtype=torch.int32)
    if quant:
        want = jattn.decode_attention_readonly(p, jnp.asarray(x), jc[0], jc[1], jl,
                                               kv_scale=(jc[2], jc[3]), **kw)
        got = tattn.decode_attention_readonly(tp, torch.from_numpy(x), tc[0], tc[1], tl,
                                              kv_scale=(tc[2], tc[3]), **kw)
    else:
        want = jattn.decode_attention_readonly(p, jnp.asarray(x), jc[0], jc[1], jl, **kw)
        got = tattn.decode_attention_readonly(tp, torch.from_numpy(x), tc[0], tc[1], tl, **kw)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)
    for c, before in zip(tc, caches):  # read-only
        np.testing.assert_array_equal(_np(c), np.asarray(before, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_attention_writes_in_place_and_matches_jax(arch):
    p, x, (k, v), length, kw = _attn_case(arch, quant=False)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    want = jattn.decode_attention(p, jnp.asarray(x), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(length, jnp.int32), **kw)
    got = tattn.decode_attention(tp, torch.from_numpy(x), tk, tv,
                                 torch.tensor(length, dtype=torch.int32), **kw)
    assert got[1] is tk and got[2] is tv
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), **TOL)


def test_cache_write_past_max_seq_raises():
    """JAX's dynamic_update_slice clamps a write past the end; the port raises."""
    cache = torch.zeros((2, 4, 1, 8))
    with pytest.raises(IndexError):
        tattn.write_at(cache, 1, torch.tensor(4, dtype=torch.int32), torch.ones((2, 1, 1, 8)))


# --------------------------------------------------------------- model --

@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_tree_matches_jax(arch):
    cfg = get_config(arch, smoke=True)
    j_params = j_init_lm(jax.random.PRNGKey(0), j_get_config(arch, smoke=True))
    t_params = init_lm(torch.Generator().manual_seed(0), cfg)
    converted = lm_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu")
    for path, t, j in _tree_pairs(t_params, j_params):
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype), path
    for path, c, j in _tree_pairs(converted, j_params):
        np.testing.assert_array_equal(c.numpy(), np.asarray(j), err_msg=path)
    assert tlayers.count_params(t_params) == jlayers.count_params(j_params)


def test_init_lm_bf16_converts_bit_for_bit_and_other_families_raise():
    """chatglm3-6b's bf16 tree carried across bit for bit.  The ssm and
    hybrid families, which raised until their slice, now build JAX's
    trees (names, shapes, dtypes; the f32 gate and state parameters stay
    f32)."""
    cfg = dataclasses.replace(j_get_config("chatglm3-6b", smoke=True), dtype="bfloat16")
    j_params = j_init_lm(jax.random.PRNGKey(0), cfg)
    t = lm_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu")
    for path, a, j in _tree_pairs(t, j_params):
        assert a.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(j).view(np.int16), err_msg=path)
    for arch in ("xlstm-125m", "zamba2-7b"):
        other = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
        j_other = dataclasses.replace(j_get_config(arch, smoke=True), dtype="bfloat16")
        t_params = init_lm(torch.Generator().manual_seed(0), other)
        for path, a, j in _tree_pairs(t_params, jax.eval_shape(
                lambda: j_init_lm(jax.random.PRNGKey(0), j_other))):
            assert tuple(a.shape) == j.shape, path
            assert str(a.dtype).removeprefix("torch.") == str(j.dtype), path


def _decode_both(arch, quant, readonly, steps=8, b=2, max_seq=16):
    j_cfg = j_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    j_params = j_init_lm(jax.random.PRNGKey(0), j_cfg)
    t_params = lm_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu")
    j_cache = jkv.init_cache(j_cfg, b, max_seq, quant=quant)
    t_cache = cache_from_numpy(jax.tree.map(np.asarray, j_cache), "cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(steps, b, 1))
    tokens = tokens.astype(np.int32)
    j_step = jax.jit(lambda c, t: jdecode.decode_step(j_params, j_cfg, t, c,
                                                      readonly_cache=readonly))
    for t in range(steps):
        j_logits, j_cache = j_step(j_cache, jnp.asarray(tokens[t]))
        t_logits, t_cache2 = decode_step(t_params, cfg, torch.from_numpy(tokens[t]),
                                         t_cache, readonly_cache=readonly)
        assert t_cache2 is t_cache  # updated in place
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **STEP_TOL,
                                   err_msg=f"step {t}")
    return j_cache, t_cache


@pytest.mark.parametrize("quant,readonly", [(False, True), (False, False), (True, True)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch, quant, readonly):
    j_cache, t_cache = _decode_both(arch, quant, readonly)
    assert int(t_cache["len"]) == int(j_cache["len"]) == 8
    assert t_cache["len"].shape == () and t_cache["len"].dtype == torch.int32
    if quant:
        for key in ("k", "v"):
            got, want = t_cache[key].numpy().astype(np.int32), np.asarray(j_cache[key], np.int32)
            assert np.abs(got - want).max() <= 1, key
            assert (got == want).mean() >= 0.99, key
        for key in ("k_scale", "v_scale"):
            got = t_cache[key].view(torch.int16).numpy().astype(np.int32)
            want = np.asarray(j_cache[key]).view(np.int16).astype(np.int32)
            assert np.abs(got - want).max() <= 1, key  # one bf16 ulp (positive scales)
    else:
        for key in ("k", "v"):
            np.testing.assert_allclose(t_cache[key].numpy(), np.asarray(j_cache[key]),
                                       **STEP_TOL)


def test_int8_cache_with_the_writing_path_raises_as_in_jax():
    cfg = get_config("chatglm3-6b", smoke=True)
    j_cfg = j_get_config("chatglm3-6b", smoke=True)
    j_params = j_init_lm(jax.random.PRNGKey(0), j_cfg)
    with pytest.raises(TypeError):
        jdecode.decode_step(j_params, j_cfg, jnp.zeros((2, 1), jnp.int32),
                            jkv.init_cache(j_cfg, 2, 16, quant=True), readonly_cache=False)
    t_params = lm_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu")
    with pytest.raises(TypeError):
        decode_step(t_params, cfg, torch.zeros((2, 1), dtype=torch.int32),
                    init_cache(cfg, 2, 16, quant=True, device="cpu"), readonly_cache=False)


# --------------------------------------------------------------- cache --

@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_and_bytes(arch, quant):
    cfg, j_cfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    cache = init_cache(cfg, batch=2, max_seq=32, quant=quant, device="cpu")
    j_cache = jkv.init_cache(j_cfg, 2, 32, quant=quant)
    assert sorted(cache) == sorted(j_cache)
    for key in cache:
        assert tuple(cache[key].shape) == j_cache[key].shape, key
        assert str(cache[key].dtype).removeprefix("torch.") == str(j_cache[key].dtype), key
    assert cache["k"].shape == (cfg.num_layers, 2, 32, cfg.kv_heads, cfg.resolved_head_dim)
    assert cache_bytes(cache) == jkv.cache_bytes(j_cache) > 0


def test_cache_of_an_unported_family_raises():
    """A family with no cache raises ``ValueError`` as the reference's
    does; the hybrid family, which raised until its slice, now builds
    JAX's cache (its ring, Mamba2 state and two lengths)."""
    cfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True), family="recsys")
    with pytest.raises(ValueError, match="no cache"):
        init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="no cache"):
        jkv.init_cache(dataclasses.replace(j_get_config("chatglm3-6b", smoke=True),
                                           family="recsys"), 1, 16)
    cache = init_cache(get_config("zamba2-7b", smoke=True), 1, 16, device="cpu")
    j_cache = jkv.init_cache(j_get_config("zamba2-7b", smoke=True), 1, 16)
    for path, a, j in _tree_pairs(cache, j_cache):
        assert tuple(a.shape) == j.shape, path
        np.testing.assert_array_equal(a.numpy(), np.asarray(j), err_msg=path)
    assert cache_bytes(cache) == jkv.cache_bytes(j_cache)


def test_full_int8_cache_bytes_per_token():
    """chatglm3-6b FULL: 28 layers × (K+V) × 2 kv heads × (128 int8 + a
    bf16 scale) = 14,560 B per cached token, computed from shapes only."""
    cfg = get_config("chatglm3-6b")
    per_token = cfg.num_layers * 2 * cfg.kv_heads * (cfg.resolved_head_dim + 2)
    assert per_token == 14_560
    small = init_cache(dataclasses.replace(cfg, num_layers=1), 1, 8, quant=True,
                       device="meta")
    assert cache_bytes(small) - 4 == per_token // cfg.num_layers * 8


# ------------------------------------------------------------- batcher --

def test_request_batcher_drains_and_measures():
    batcher = RequestBatcher(batch_size=2, eos_id=-1)
    for uid in range(5):
        batcher.submit(Request(uid=uid, prompt=np.array([1, 2]), max_new_tokens=4))

    def prefill_fn(slot, prompt):
        return int(prompt[-1]) + 1

    def decode_fn(active, last):
        return last + 1

    ticks = 0
    while not batcher.idle:
        batcher.tick(prefill_fn, decode_fn)
        ticks += 1
        assert ticks < 100
    s = batcher.metrics.summary()
    assert s["completed"] == 5
    assert s["tokens_out"] > 0


def test_request_batcher_respects_slot_limit():
    batcher = RequestBatcher(batch_size=2, eos_id=-1)
    for uid in range(4):
        batcher.submit(Request(uid=uid, prompt=np.array([1]), max_new_tokens=100))
    active = batcher.tick(lambda s, p: 0, lambda a, l: l)
    assert active == 2


def test_request_batcher_is_jax_batcher():
    """Same admission, tokens and counters as ``repro.serve.batching``."""
    runs = []
    for mod in (j_batching, __import__("repro_torch.serve.batching", fromlist=["x"])):
        b = mod.RequestBatcher(batch_size=3, eos_id=7)
        reqs = [mod.Request(uid=u, prompt=np.array([u, u + 1]), max_new_tokens=3 + u % 3)
                for u in range(7)]
        for r in reqs:
            b.submit(r)
        while not b.idle:
            b.tick(lambda s, p: int(p.sum()) % 11, lambda a, last: (last * 3 + 1) % 11)
        runs.append(([r.generated for r in reqs], [r.slot for r in reqs],
                     b.metrics.completed, b.metrics.tokens_out))
    assert runs[0] == runs[1]


# ------------------------------------------------------------ launcher --

def test_serve_main_on_cpu_serves_to_the_end():
    report = tserve.main(["--device", "cpu", "--kv-int8"])
    assert report["completed"] == 8
    assert report["tokens_out"] == 8 * 11  # the first token of each comes from prefill
    assert report["kv_int8"] and report["device"] == "cpu"
    assert report["steps"] == 8 * 4 + report["ticks"]  # prompt steps + one step a tick
    assert report["cache_bytes"] > 0 and report["weight_bytes"] == 4 * report["params"]


@pytest.mark.parametrize("quant", [False, True])
def test_served_tokens_equal_jax_serving(quant):
    """The whole slice: the launcher's serve loop on JAX's weights and the
    JAX launcher's loop (prefill by decode steps, greedy argmax) give the
    same tokens for every request."""
    arch, slots, max_seq, n, prompt_len, max_new = "chatglm3-6b", 2, 64, 4, 4, 6
    j_cfg = j_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    j_params = j_init_lm(jax.random.PRNGKey(0), j_cfg)

    state = {"cache": jkv.init_cache(j_cfg, slots, max_seq, quant=quant)}
    dstep = jax.jit(lambda c, t: jdecode.decode_step(j_params, j_cfg, t, c))

    def prefill_fn(slot, prompt):
        tok = np.zeros((slots, 1), np.int32)
        last = 0
        for t in prompt:
            tok[slot, 0] = int(t)
            logits, state["cache"] = dstep(state["cache"], jnp.asarray(tok))
            last = int(jnp.argmax(logits[slot, -1, : j_cfg.vocab_size]))
        return last

    def decode_fn(active, last_tokens):
        logits, state["cache"] = dstep(state["cache"], jnp.asarray(last_tokens[:, None]))
        return np.asarray(jnp.argmax(logits[:, -1, : j_cfg.vocab_size], axis=-1))

    j_reqs = [j_batching.Request(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
              for r in tserve.make_requests(cfg, n, prompt_len, max_new)]
    batcher = j_batching.RequestBatcher(slots, eos_id=-1)
    for r in j_reqs:
        batcher.submit(r)
    while not batcher.idle:
        batcher.tick(prefill_fn, decode_fn)

    t_params = lm_params_from_numpy(jax.tree.map(np.asarray, j_params), "cpu")
    t_cache = init_cache(cfg, slots, max_seq, quant=quant, device="cpu")
    t_reqs = tserve.make_requests(cfg, n, prompt_len, max_new)
    report = tserve.serve(t_params, cfg, t_cache, t_reqs)
    assert [r.generated for r in t_reqs] == [r.generated for r in j_reqs]
    assert int(t_cache["len"]) == int(state["cache"]["len"]) == report["steps"]


def test_serve_refuses_to_write_past_max_seq():
    cfg = get_config("chatglm3-6b", smoke=True)
    params, cache = tserve.build(cfg, 1, 6, kv_int8=True, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        tserve.serve(params, cfg, cache, tserve.make_requests(cfg, 1, 4, 8))
