"""Error-feedback gradient compression for the slow (cross-pod) axis.

The port of ``repro.train.compression``: int8 quantization with a
per-leaf scale ``max|g + e| / 127 + 1e-12`` (rounded half to even, as
``jnp.round``) and *error feedback*: the quantization residual ``e`` is
carried in :class:`CompressionState` and added into the next step's
gradient, which keeps SGD convergence unbiased in practice.
``compress`` runs before the cross-pod reduction, ``decompress`` after.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train.tree import map_n


class CompressionState(NamedTuple):
    error: Any   # residual tree, same structure as grads (f32)


def init_compression(grads_like) -> CompressionState:
    return CompressionState(error=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _one(g, e):
    gf = g.float() + e
    scale = gf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale, gf - q.float() * scale


def compress(grads, state: CompressionState) -> Tuple[Any, Any, CompressionState]:
    """Returns (int8 payload, scales, new_state). Residual goes to state."""
    payload, scales, errors = map_n(_one, 3, grads, state.error)
    return payload, scales, CompressionState(error=errors)

def decompress(payload, scales):
    return tree_map(lambda q, s: q.float() * s, payload, scales)


def compressed_bytes(grads) -> int:
    """Bytes on the wire after compression (int8: 1 B a value)."""
    return sum(g.numel() for g in tree_leaves(grads))


def raw_bytes(grads) -> int:
    return sum(g.numel() * g.element_size() for g in tree_leaves(grads))
