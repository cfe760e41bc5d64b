"""One-token decode of the moe, vlm and audio families and the two
remaining dense configs against the JAX package, on the CPU, and the
serving launcher on them.

Inputs as in ``tests/test_torch_lm_families.py`` (smoke configs in
float32, JAX's parameters carried across, vlm gates at 0.5, image
embeddings N(0, 0.1²)).  The port's int8 attention runs the
flash-decode kernel's plain version (CPU tensors).

Tolerances are ``tests/test_torch_lm_decode.py``'s: ``decode_step``
logits atol and rtol 1e-4 over 6 steps; int8 cache entries within 1 of
JAX's with at least 99 % equal, scales within one bf16 ulp; float caches
atol and rtol 1e-4.  ``forward`` against ``decode_step`` token by token
atol 5e-4, rtol 5e-3 (``tests/test_archs_smoke.py``), the moe layers
drop-free (``capacity_factor = num_experts``), as
``tests/test_archs_smoke.py:95-100`` runs them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import batching as j_batching
from repro.serve import decode as jdecode
from repro.serve import kvcache as jkv
from repro_torch.configs import get_config
from repro_torch.convert import cache_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttf
from repro_torch.serve.decode import decode_step
from repro_torch.serve.kvcache import cache_bytes, init_cache

from _torch_lm_families_cases import _j, _t, lm_case

STEP_TOL = dict(atol=1e-4, rtol=1e-4)
DECODE_TOL = dict(atol=5e-4, rtol=5e-3)
STEPS = 6


def _decode_both(arch, quant, readonly, b=2, max_seq=16):
    j_cfg, cfg, jp, tp, _, _, enc = lm_case(arch, b=b)
    j_cache = jkv.init_cache(j_cfg, b, max_seq, quant=quant)
    t_cache = cache_from_numpy(jax.tree.map(np.asarray, j_cache), "cpu")
    lead = (b, cfg.num_codebooks) if cfg.family == "audio" else (b,)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(STEPS, *lead, 1))
    tokens = tokens.astype(np.int32)
    j_step = jax.jit(lambda c, t: jdecode.decode_step(jp, j_cfg, t, c, enc=_j(enc),
                                                      readonly_cache=readonly))
    for t in range(STEPS):
        j_logits, j_cache = j_step(j_cache, jnp.asarray(tokens[t]))
        t_logits, t_cache2 = decode_step(tp, cfg, torch.from_numpy(tokens[t]), t_cache,
                                         enc=_t(enc), readonly_cache=readonly)
        assert t_cache2 is t_cache  # updated in place
        assert t_logits.shape == j_logits.shape
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **STEP_TOL,
                                   err_msg=f"step {t}")
    return j_cache, t_cache


CASES = [
    ("granite-moe-3b-a800m", True, True), ("granite-moe-3b-a800m", False, True),
    ("granite-moe-3b-a800m", False, False), ("grok-1-314b", True, True),
    ("grok-1-314b", False, False), ("musicgen-medium", True, True),
    ("musicgen-medium", False, False), ("llama-3.2-vision-11b", False, True),
    ("minicpm-2b", True, True), ("command-r-35b", True, True),
]


@pytest.mark.parametrize("arch,quant,readonly", CASES)
def test_decode_step_matches_jax(arch, quant, readonly):
    j_cache, t_cache = _decode_both(arch, quant, readonly)
    assert sorted(t_cache) == sorted(j_cache)
    assert int(t_cache["len"]) == int(j_cache["len"]) == STEPS
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


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama-3.2-vision-11b",
                                  "musicgen-medium"])
def test_cache_shapes_and_bytes(arch, quant):
    """A vlm cache holds the self-attention layers only and ignores
    ``quant``, as JAX's does."""
    j_cfg, cfg = lm_case(arch)[:2]
    cache = init_cache(cfg, batch=2, max_seq=32, quant=quant, device="cpu")
    j_cache = jkv.init_cache(j_cfg, 2, 32, quant=quant)
    assert sorted(cache) == sorted(j_cache)
    for key in cache:
        assert tuple(cache[key].shape) == j_cache[key].shape, key
        assert str(cache[key].dtype).removeprefix("torch.") == str(j_cache[key].dtype), key
    assert cache_bytes(cache) == jkv.cache_bytes(j_cache) > 0
    if cfg.family == "vlm":
        assert cache["k"].shape[0] == 4 and "k_scale" not in cache


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "grok-1-314b",
                                  "llama-3.2-vision-11b", "musicgen-medium"])
def test_forward_agrees_with_decode_step(arch):
    j_cfg = lm_case(arch)[0]
    over = {"moe": dataclasses.replace(
        j_cfg.moe, capacity_factor=float(j_cfg.moe.num_experts))} if j_cfg.moe else None
    _, cfg, _, tp, tokens, _, enc = lm_case(arch, b=2, s=10, seed=2, cfg_overrides=over)
    with torch.no_grad():
        full, _ = ttf.forward(tp, cfg, torch.from_numpy(tokens), enc=_t(enc))
        cache = init_cache(cfg, 2, 16, device="cpu")
        for t in range(tokens.shape[-1]):
            step, _ = decode_step(tp, cfg, torch.from_numpy(tokens[..., t:t + 1]), cache,
                                  enc=_t(enc))
            np.testing.assert_allclose(step[..., 0, :].numpy(), full[..., t, :].numpy(),
                                       err_msg=f"token {t}", **DECODE_TOL)


def test_vlm_decode_needs_enc():
    _, cfg, _, tp, tokens, _, _ = lm_case("llama-3.2-vision-11b")
    with pytest.raises(ValueError, match="enc"):
        decode_step(tp, cfg, torch.from_numpy(tokens[:, :1]),
                    init_cache(cfg, 2, 16, device="cpu"))


# ------------------------------------------------------------ launcher --

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "llama-3.2-vision-11b"])
def test_serve_main_on_cpu_serves_moe_and_vlm(arch):
    report = tserve.main(["--device", "cpu", "--arch", arch, "--kv-int8", "--requests", "4"])
    assert report["completed"] == 4 and report["arch"] == arch
    assert report["tokens_out"] == 4 * 11  # the first token of each comes from prefill
    # a vlm cache ignores --kv-int8, as JAX's does
    assert ("k_scale" in init_cache(get_config(arch, smoke=True), 1, 8, quant=True,
                                    device="cpu")) == (arch != "llama-3.2-vision-11b")


def test_serve_refuses_audio_as_jax_does():
    with pytest.raises(SystemExit, match="musicgen"):
        tserve.main(["--device", "cpu", "--arch", "musicgen-medium"])


@pytest.mark.parametrize("arch,quant", [("granite-moe-3b-a800m", True),
                                        ("llama-3.2-vision-11b", False)])
def test_served_tokens_equal_jax_serving(arch, quant):
    """The launcher's serve loop on JAX's weights (gates at 0.5) and the JAX
    launcher's loop, with the launchers' zero image embeddings for vlm,
    give the same tokens for every request."""
    slots, max_seq, n, prompt_len, max_new = 2, 64, 4, 4, 6
    j_cfg, cfg, jp, tp, _, _, _ = lm_case(arch)
    enc = tserve.image_embeddings(cfg, slots, "cpu")
    j_enc = None if enc is None else jnp.zeros(enc.shape, jnp.float32)
    state = {"cache": jkv.init_cache(j_cfg, slots, max_seq, quant=quant)}
    dstep = jax.jit(lambda c, t: jdecode.decode_step(jp, j_cfg, t, c, enc=j_enc))

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

    t_cache = init_cache(cfg, slots, max_seq, quant=quant, device="cpu")
    t_reqs = tserve.make_requests(cfg, n, prompt_len, max_new)
    report = tserve.serve(tp, cfg, t_cache, t_reqs, enc=enc)
    assert [r.generated for r in t_reqs] == [r.generated for r in j_reqs]
    assert int(t_cache["len"]) == int(state["cache"]["len"]) == report["steps"]
