"""Shared building blocks of the port's models: initializers, norms, MLPs
and the helpers over stacked layer parameters.

The port of ``repro.models.layers``.  Parameters are plain nested dicts
of tensors, as in the JAX package, and a dense weight keeps JAX's
``(d_in, d_out)`` layout (``x @ w + b``).  Random draws come from one
``torch.Generator`` used in sequence where JAX splits keys; the
distributions match JAX's, the bits do not (the generators differ).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------- inits --

def on_device(generator: torch.Generator, device=None) -> torch.device:
    """``device``, or the generator's device when it is ``None``: where the
    init helpers put what they draw.  A ``"meta"`` device with a CPU
    generator makes the tree's shapes and dtypes without its values (the
    dry run's parameters)."""
    return generator.device if device is None else torch.device(device)


def _trunc_normal(generator: torch.Generator, shape, std: float, dtype,
                  device=None) -> torch.Tensor:
    """Truncated normal (±3 σ) drawn in float32 on ``device`` (default the
    generator's), scaled by ``std`` and cast once to ``dtype``."""
    w = torch.empty(shape, device=on_device(generator, device))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * std).to(dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, dtype,
               *, scale: float = 1.0, device=None) -> torch.Tensor:
    """``(in_dim, out_dim)`` truncated normal with σ = scale/√in_dim."""
    return _trunc_normal(generator, (in_dim, out_dim), scale / math.sqrt(in_dim), dtype, device)


def embed_init(generator: torch.Generator, vocab: int, dim: int, dtype,
               device=None) -> torch.Tensor:
    """``(vocab, dim)`` truncated normal with σ = 0.02."""
    return _trunc_normal(generator, (vocab, dim), 0.02, dtype, device)


# ---------------------------------------------------------------- norms --

def init_norm(d: int, kind: str, dtype, device="cpu") -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm in JAX's order: normalize in float32, cast to
    ``x.dtype``, multiply by the scale, add the bias."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y.to(x.dtype) * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y


# ----------------------------------------------------------------- mlps --

def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, act: str, dtype,
             *, use_bias: bool = False, device=None) -> Params:
    device = on_device(generator, device)
    p: Params = {}
    if act in ("swiglu", "geglu"):
        p["in_gate"] = dense_init(generator, d_model, d_ff, dtype, device=device)
    p["out"] = dense_init(generator, d_ff, d_model, dtype, scale=0.5, device=device)
    p["in_val"] = dense_init(generator, d_model, d_ff, dtype, device=device)
    if use_bias:
        p["bias_out"] = torch.zeros((d_model,), dtype=dtype, device=device)
    return p


def apply_mlp(p: Params, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    # JAX's jax.nn.gelu defaults to the tanh approximation
    if act == "swiglu":
        h = F.silu(x @ p["in_gate"]) * (x @ p["in_val"])
    elif act == "geglu":
        h = F.gelu(x @ p["in_gate"], approximate="tanh") * (x @ p["in_val"])
    else:
        h = F.gelu(x @ p["in_val"], approximate="tanh")
    y = h @ p["out"]
    if "bias_out" in p:
        y = y + p["bias_out"]
    return y


# ------------------------------------------------------------- pytrees --

def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists, tuples and
    ``NamedTuple``s (``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        mapped = (tree_map(fn, *xs) for xs in zip(tree, *rest))
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def stack_layers(layer_params: list) -> Params:
    """Stacks per-layer trees into leading-axis tensors."""
    return tree_map(lambda *xs: torch.stack(xs), *layer_params)


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda x: x[i], stacked)


def count_params(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def cast_floats(tree: Params, dtype) -> Params:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)
