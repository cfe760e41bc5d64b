"""The recurrent LM families of the port against the JAX package, on the
CPU: ``xlstm-125m`` (ssm: sLSTM and mLSTM blocks) and ``zamba2-7b``
(hybrid: Mamba2 with one shared attention over a ring window).  Configs,
``init_lm`` trees, ``forward`` and ``lm_loss`` with their gradients (at
s 16 and at the chunk thresholds), ``decode_step`` and its caches, the
ring past its window, the caches, and the serve loop against the JAX
launcher's (training and the launchers: ``tests/test_torch_lm_recurrent_train.py``).

JAX's parameters, caches and ``TrainState`` are carried across by
``repro_torch.convert``; tokens are drawn with numpy.  Configs are the
smoke configs in float32 (xlstm: 4 layers, sLSTM at 0 and 2; zamba: 5
layers, 2 superblocks of 2 Mamba2 layers and a 1-layer tail).

Tolerances: ``forward`` logits, ``lm_loss``, its gradients, the decode
logits and caches, the train step's loss, grad norm, parameters and
optimizer state atol and rtol 1e-4 (``tests/test_torch_lm_forward.py``;
XLA and torch sum the float32 matmuls in other orders); ``forward``
against ``decode_step`` token by token atol 5e-4, rtol 5e-3
(``tests/test_archs_smoke.py:113``); zamba's ``forward``, ``lm_loss`` and
gradients at 4,096 tokens atol 1e-3, rtol 1e-4: at 4,096 steps the SSD
chunk form's float32 error against the exact recurrence is ≈ 1.7e-5 a
Mamba2 layer in both packages (the cumulative log decays reach -10³, and
``cum_t − cum_t'`` cancels), and the port and JAX round it differently,
≈ 2.3e-5 a layer, ≈ 4e-4 on the logits after 5 layers; window 8 against window 64 within
the window 1e-5 (``tests/test_serve.py:61``); ``remat=True`` against
``remat=False`` and checkpoints bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as j_base
from repro.configs import get_config as j_get_config
from repro.models import forward as j_forward
from repro.models import init_lm as j_init_lm
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.models import xlstm as jx
from repro.serve import batching as j_batching
from repro.serve import decode as jdecode
from repro.serve import kvcache as jkv
from repro_torch.configs import base as t_base
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import cache_from_numpy, lm_params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf
from repro_torch.models.layers import tree_map
from repro_torch.serve import kvcache as tkv
from repro_torch.serve.decode import decode_step
from repro_torch.train.tree import flatten_with_names

from _torch_lm_families_cases import _tree_pairs, lm_case

STEP_TOL = dict(atol=1e-4, rtol=1e-4)
LONG_SSD_TOL = dict(atol=1e-3, rtol=1e-4)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)
ARCHS = ["xlstm-125m", "zamba2-7b"]
THRESHOLD = {"xlstm-125m": ttf.MLSTM_CHUNK_THRESHOLD, "zamba2-7b": ttf.CHUNKED_ATTN_THRESHOLD}


def _np(t):
    return t.detach().float().numpy()


def _jnames(tree):
    return {jax.tree_util.keystr(p, simple=True, separator="/").replace(".", ""): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(port, ref, **tol):
    """Leaf by leaf, matched by JAX's path names."""
    got = {k.replace(".", ""): v for k, v in flatten_with_names(port)}
    want = _jnames(ref)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(_np(got[name]), np.asarray(want[name], np.float32),
                                   err_msg=name, **tol)


# ------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_equal_jax(arch, smoke):
    t_cfg, j_cfg = get_config(arch, smoke=smoke), j_get_config(arch, smoke=smoke)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert t_cfg.param_count() == j_cfg.param_count()
    assert t_cfg.padded_vocab == j_cfg.padded_vocab
    assert t_base.supported_shapes(t_cfg) == j_base.supported_shapes(j_cfg)


def test_list_configs_equals_jax():
    assert list_configs() == j_base.list_configs()


# ---------------------------------------------------------------- init --

TREES = [("xlstm-125m", None), ("zamba2-7b", None), ("zamba2-7b", {"num_layers": 4}),
         ("xlstm-125m", {"dtype": "bfloat16"}), ("zamba2-7b", {"dtype": "bfloat16"})]


@pytest.mark.parametrize("arch,overrides", TREES,
                         ids=["xlstm", "zamba", "zamba-no-tail", "xlstm-bf16", "zamba-bf16"])
def test_init_lm_tree_matches_jax(arch, overrides):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **(overrides or {}))
    j_cfg = dataclasses.replace(j_get_config(arch, smoke=True), **(overrides or {}))
    tp = ttf.init_lm(torch.Generator().manual_seed(0), cfg)
    jp = j_init_lm(jax.random.PRNGKey(0), j_cfg)
    for path, a, j in _tree_pairs(tp, jp):
        assert tuple(a.shape) == j.shape, path
        assert str(a.dtype).removeprefix("torch.") == str(j.dtype), path
    assert tlayers.count_params(tp) == jlayers.count_params(jp)


def test_init_lm_without_slstm_leaves_the_key_out():
    """At ``slstm_every = 0`` JAX's ``init_lm`` raises on the empty sLSTM
    stack; the port's tree has only ``"mlstm"``, the tree JAX's forward
    reads there."""
    cfg = dataclasses.replace(get_config("xlstm-125m", smoke=True), slstm_every=0)
    with pytest.raises(TypeError):
        j_init_lm(jax.random.PRNGKey(0), dataclasses.replace(
            j_get_config("xlstm-125m", smoke=True), slstm_every=0))
    tp = ttf.init_lm(torch.Generator().manual_seed(0), cfg)
    assert sorted(tp["layers"]) == ["mlstm"]
    assert tp["layers"]["mlstm"]["cell"]["wq"].shape[0] == cfg.num_layers
    assert ttf.num_slstm(cfg) == 0 and ttf.num_slstm(get_config("xlstm-125m")) == 2


def _mlstm_only(j_cfg, seed=0):
    """JAX parameters of an xlstm stack without sLSTM, built from its
    blocks (its ``init_lm`` cannot)."""
    ks = jax.random.split(jax.random.PRNGKey(seed), j_cfg.num_layers + 1)
    jp = j_init_lm(ks[-1], dataclasses.replace(j_cfg, slstm_every=2))
    jp["layers"] = {"mlstm": jlayers.stack_layers([
        {"norm": jlayers.init_norm(j_cfg.d_model, j_cfg.norm, j_cfg.jnp_dtype),
         "cell": jx.init_mlstm(k, j_cfg.d_model, j_cfg.num_heads, j_cfg.jnp_dtype)}
        for k in ks[:-1]])}
    return jp


# ------------------------------------------------------------- forward --

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("long", [False, True], ids=["s16", "threshold"])
def test_forward_loss_and_grads_match_jax(arch, long):
    """At s 16 (the sequential mLSTM, full shared attention) and at the
    chunk threshold (256: the chunkwise mLSTM; 4,096: the chunked shared
    attention with its 4,096 window)."""
    s, b = (THRESHOLD[arch], 1) if long else (16, 2)
    tol = LONG_SSD_TOL if long and arch == "zamba2-7b" else STEP_TOL
    j_cfg, cfg, jp, tp, tokens, labels, _ = lm_case(arch, b=b, s=s)
    (j_loss, want), j_g = jax.jit(jax.value_and_grad(
        lambda p: (jtf.lm_loss(p, j_cfg, tokens, labels), j_forward(p, j_cfg, tokens)[0]),
        has_aux=True))(jp)
    live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    got, aux = ttf.forward(live, cfg, torch.from_numpy(tokens))
    assert got.shape == want.shape and float(aux) == 0.0
    np.testing.assert_allclose(_np(got), np.asarray(want), **tol)
    loss = ttf.lm_loss(live, cfg, torch.from_numpy(tokens), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), **tol)
    loss.backward()
    assert_trees_close(tree_map(lambda t: t.grad, live), j_g, **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_identical(arch):
    _, cfg, _, tp, tokens, labels, _ = lm_case(arch, b=2, s=12)
    out = []
    for remat in (False, True):
        live = tree_map(lambda t: t.clone().requires_grad_(True), tp)
        loss = ttf.lm_loss(live, cfg, torch.from_numpy(tokens), torch.from_numpy(labels),
                           remat=remat)
        loss.backward()
        out.append((loss.detach(), [g for _, g in flatten_with_names(
            tree_map(lambda t: t.grad, live))]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_forward_without_slstm_matches_jax():
    j_cfg = dataclasses.replace(j_get_config("xlstm-125m", smoke=True), slstm_every=0)
    cfg = dataclasses.replace(get_config("xlstm-125m", smoke=True), slstm_every=0)
    jp = _mlstm_only(j_cfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want, _ = j_forward(jp, j_cfg, jnp.asarray(tokens))
    got, _ = ttf.forward(tp, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(got), np.asarray(want), **STEP_TOL)


# -------------------------------------------------------------- decode --

DECODE_CASES = {
    "xlstm": ("xlstm-125m", None, {}),
    "xlstm-no-slstm": ("xlstm-125m", {"slstm_every": 0}, {}),
    "zamba": ("zamba2-7b", None, {"window": 64}),
    "zamba-no-tail": ("zamba2-7b", {"num_layers": 4}, {}),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_step_matches_jax(case):
    """Eight steps from JAX's empty cache (carried across): logits each
    step, then every cache tensor, updated in place."""
    arch, overrides, kw = DECODE_CASES[case]
    b, steps = 2, 8
    if overrides and "slstm_every" in overrides:
        j_cfg = dataclasses.replace(j_get_config(arch, smoke=True), **overrides)
        cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
        jp = _mlstm_only(j_cfg)
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    else:
        j_cfg, cfg, jp, tp, _, _, _ = lm_case(arch, cfg_overrides=overrides)
    j_cache = jkv.init_cache(j_cfg, b, 32, **kw)
    t_cache = cache_from_numpy(jax.tree.map(np.asarray, j_cache), "cpu")
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (steps, b, 1)).astype(np.int32)
    j_step = jax.jit(lambda c, t: jdecode.decode_step(jp, j_cfg, t, c))
    for t in range(steps):
        j_logits, j_cache = j_step(j_cache, jnp.asarray(tokens[t]))
        with torch.no_grad():
            t_logits, same = decode_step(tp, cfg, torch.from_numpy(tokens[t]), t_cache)
        assert same is t_cache
        np.testing.assert_allclose(_np(t_logits), np.asarray(j_logits), err_msg=f"step {t}",
                                   **STEP_TOL)
    assert_trees_close(t_cache, j_cache, **STEP_TOL)
    assert int(t_cache["len"]) == steps


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_agrees_with_decode_step(arch):
    _, cfg, _, tp, tokens, _, _ = lm_case(arch, b=2, s=8, seed=3)
    with torch.no_grad():
        full, _ = ttf.forward(tp, cfg, torch.from_numpy(tokens))
        cache = tkv.init_cache(cfg, 2, 16, device="cpu")
        for t in range(tokens.shape[1]):
            step, _ = decode_step(tp, cfg, torch.from_numpy(tokens[:, t:t + 1]), cache)
            np.testing.assert_allclose(_np(step[:, 0]), _np(full[:, t]), err_msg=f"token {t}",
                                       **DECODE_TOL)


def test_ring_decodes_beyond_its_window_as_jax_does():
    """``tests/test_serve.py:31``: 2·8+3 steps through a ring of 8; the
    logits stay finite and equal JAX's through the wraps, and the ring's
    positions are the last 8."""
    j_cfg, cfg, jp, tp, _, _, _ = lm_case("zamba2-7b")
    W, n = 8, 2 * 8 + 3
    j_cache = jkv.init_cache(j_cfg, 1, 1 << 12, window=W)
    t_cache = tkv.init_cache(cfg, 1, 1 << 12, window=W, device="cpu")
    j_step = jax.jit(lambda c, t: jdecode.decode_step(jp, j_cfg, t, c))
    for t in range(n):
        tok = np.full((1, 1), t % cfg.vocab_size, np.int32)
        j_logits, j_cache = j_step(j_cache, jnp.asarray(tok))
        with torch.no_grad():
            logits, _ = decode_step(tp, cfg, torch.from_numpy(tok), t_cache)
        assert bool(torch.isfinite(logits).all()), f"step {t}"
        np.testing.assert_allclose(_np(logits), np.asarray(j_logits), err_msg=f"step {t}",
                                   **STEP_TOL)
    assert int(t_cache["len"]) == int(t_cache["shared"]["len"]) == n
    assert sorted(t_cache["shared"]["pos"][0, 0].tolist()) == list(range(n - W, n))
    np.testing.assert_array_equal(t_cache["shared"]["pos"].numpy(),
                                  np.asarray(j_cache["shared"]["pos"]))
    assert_trees_close(t_cache, j_cache, **STEP_TOL)


def test_window_8_equals_window_64_within_the_window():
    """``tests/test_serve.py:45``: while the length stays within the
    window, the ring of 8 decodes as the ring of 64."""
    _, cfg, _, tp, _, _, _ = lm_case("zamba2-7b")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (6, 1, 1)).astype(np.int32)
    outs = []
    for W in (64, 8):
        cache = tkv.init_cache(cfg, 1, 64, window=W, device="cpu")
        with torch.no_grad():
            outs.append(torch.cat([decode_step(tp, cfg, torch.from_numpy(t), cache)[0]
                                   for t in toks], dim=1))
    np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), atol=1e-5)


# --------------------------------------------------------------- caches --

@pytest.mark.parametrize("arch,max_seq,kw", [
    ("xlstm-125m", 32, {}), ("zamba2-7b", 32, {}), ("zamba2-7b", 32, {"window": 8}),
    ("zamba2-7b", 1 << 19, {"window": 16}), ("zamba2-7b", 32, {"quant": True}),
])
def test_cache_shapes_dtypes_and_bytes(arch, max_seq, kw):
    cfg, j_cfg = get_config(arch, smoke=True), j_get_config(arch, smoke=True)
    cache = tkv.init_cache(cfg, 2, max_seq, device="cpu", **kw)
    j_cache = jkv.init_cache(j_cfg, 2, max_seq, **kw)
    got = {k.replace(".", ""): v for k, v in flatten_with_names(cache)}
    want = _jnames(j_cache)
    assert sorted(got) == sorted(want)
    for name, j in want.items():
        assert tuple(got[name].shape) == j.shape, name
        assert str(got[name].dtype).removeprefix("torch.") == str(j.dtype), name
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(j), err_msg=name)
    assert tkv.cache_bytes(cache) == jkv.cache_bytes(j_cache) > 0
    assert tkv.cache_slots(cache) == 2
    if cfg.family == "hybrid":   # the ring never outgrows its window
        assert cache["shared"]["k"].shape[2] == min(kw.get("window", 4096), max_seq)
        assert tkv.cache_bytes(cache) < 50e6


def test_full_cache_bytes():
    """From shapes: the zamba2-7b FULL ring at 4 slots × 4,096 (13 layers
    of K and V, 32 heads of 112, bf16) and its Mamba2 state."""
    cfg = get_config("zamba2-7b")
    ring = 13 * 2 * 4 * 4096 * 32 * 112 * 2 + 13 * 4 * 4096 * 4    # K, V and positions
    mamba = 81 * 4 * (112 * 64 * 64 * 4 + 3 * 7168 * 2)             # h f32, conv bf16
    assert (ring, mamba) == (3_054_305_280, 608_477_184)
    assert ttf.zamba_layout(cfg) == (13, 6, 3)
    j_cache = jax.eval_shape(lambda: jkv.init_cache(j_get_config("zamba2-7b"), 4, 4096))
    assert sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(j_cache)) == ring + mamba + 8


# -------------------------------------------------------------- serve --

@pytest.mark.parametrize("arch", ARCHS)
def test_served_tokens_equal_jax_serving_past_max_seq(arch):
    """The launcher's serve loop and the JAX launcher's, on JAX's weights,
    give the same tokens; ``max_seq`` 8 is a ring of 8 for zamba, and
    serving runs past it (the recurrent state has no length)."""
    slots, max_seq, n, prompt_len, max_new = 2, 8, 4, 4, 6
    j_cfg, cfg, jp, tp, _, _, _ = lm_case(arch)
    state = {"cache": jkv.init_cache(j_cfg, slots, max_seq)}
    dstep = jax.jit(lambda c, t: jdecode.decode_step(jp, j_cfg, t, c))

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

    t_cache = tkv.init_cache(cfg, slots, max_seq, device="cpu")
    t_reqs = tserve.make_requests(cfg, n, prompt_len, max_new)
    with torch.no_grad():
        report = tserve.serve(tp, cfg, t_cache, t_reqs)
    assert [r.generated for r in t_reqs] == [r.generated for r in j_reqs]
    assert int(t_cache["len"]) == int(state["cache"]["len"]) == report["steps"] > max_seq
