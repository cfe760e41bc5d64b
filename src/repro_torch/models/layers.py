"""Shared building blocks of the port's models: the parameter alias and
the fan-in initializer.

The port of the part of ``repro.models.layers`` that DLRM uses.
Parameters are plain nested dicts of tensors, as in the JAX package, and
a dense weight keeps JAX's ``(d_in, d_out)`` layout (``x @ w + b``).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

Params = Dict[str, Any]


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int, dtype,
               *, scale: float = 1.0) -> torch.Tensor:
    """``(in_dim, out_dim)`` truncated normal (±3 σ) with σ = scale/√in_dim,
    drawn on the generator's device.  The same distribution as JAX's
    ``dense_init``; the bits differ, since the generators do."""
    std = scale / math.sqrt(in_dim)
    w = torch.empty((in_dim, out_dim), device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * std).to(dtype)
