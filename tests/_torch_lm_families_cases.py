"""Shared inputs of the LM-family tests (``tests/test_torch_lm_families*.py``):
both packages' smoke configs, JAX's parameters with the vlm gates open and
the port's copy, seeded tokens and image embeddings."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy

GATE = 0.5


def _tree_pairs(a, b, path="root"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in sorted(a):
            yield from _tree_pairs(a[k], b[k], f"{path}.{k}")
    else:
        yield path, a, b


def open_gates(params):
    """A vlm tree with every cross-attention gate at ``GATE`` (zero at
    init); other trees unchanged."""
    layers = params["layers"]
    if "cross" not in layers:
        return params
    xattn = dict(layers["cross"]["xattn"])
    xattn["gate"] = jnp.full(xattn["gate"].shape, GATE, xattn["gate"].dtype)
    cross = dict(layers["cross"], xattn=xattn)
    return dict(params, layers=dict(layers, cross=cross))


def lm_case(arch, b=2, s=12, seed=0, cfg_overrides=None):
    """Both packages' configs, JAX's parameters (gates open) and the port's
    copy, tokens and labels ``(b, s)`` (audio ``(b, K, s)``) and, for vlm,
    image embeddings ``(b, num_image_tokens, d_model)``."""
    j_cfg, cfg = j_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if cfg_overrides:
        j_cfg = dataclasses.replace(j_cfg, **cfg_overrides)
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    jp = open_gates(j_init_lm(jax.random.PRNGKey(seed), j_cfg))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(seed)
    lead = (b, cfg.num_codebooks) if cfg.family == "audio" else (b,)
    toks = rng.integers(0, cfg.vocab_size, size=(*lead, s + 1)).astype(np.int32)
    enc = None
    if cfg.family == "vlm":
        enc = (rng.normal(size=(b, cfg.num_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return j_cfg, cfg, jp, tp, toks[..., :-1], toks[..., 1:], enc


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)
