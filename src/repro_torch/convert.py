"""Weights and state carried across from the JAX package, as NumPy arrays.

The JAX side hands over host arrays (``np.asarray`` of its ``jax.Array``s);
these helpers turn them into the port's tensors bit for bit.  bfloat16
arrays (NumPy's ``ml_dtypes`` extension type, which torch cannot read
directly) travel as their 16-bit patterns.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # e.g. np.asarray of a jax.Array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def tables_from_numpy(
    tables: Dict[str, np.ndarray], device="cuda"
) -> Dict[str, torch.Tensor]:
    """``{name: (rows, dim) array}`` → ``{name: tensor on device}``.

    The ``tables`` argument of :class:`repro_torch.serve.
    ShardedEmbeddingServer`; the same arrays the JAX server takes, and
    DLRM's ``params["tables"]``.
    """
    return {name: _tensor(np.asarray(t), device) for name, t in tables.items()}


def shard_images_from_numpy(images: np.ndarray, device="cuda") -> torch.Tensor:
    """``np.asarray(jax_server.shard_images)`` → the port's image stack,
    ``(num_shards, local_tiles, tile_rows, dim)`` on ``device``."""
    return _tensor(np.asarray(images), device)


def dlrm_params_from_numpy(params, device="cuda"):
    """JAX ``init_dlrm``'s tree of host arrays → the port's DLRM parameters.

    ``{"tables": {name: (rows, dim)}, "bottom": [{"w", "b"}, ...], "top":
    [...]}`` keeps its structure and every array its layout, bit for bit:
    a dense ``w`` stays ``(d_in, d_out)`` (both packages compute
    ``x @ w + b``), so no transpose is made.
    """
    if isinstance(params, dict):
        return {k: dlrm_params_from_numpy(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [dlrm_params_from_numpy(v, device) for v in params]
    return _tensor(np.asarray(params), device)
