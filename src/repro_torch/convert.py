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

from repro_torch.models.layers import tree_map
from repro_torch.train.loop import TrainState
from repro_torch.train.optimizer import AdafactorState, AdamWState


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    shape = np.shape(a)
    a = np.ascontiguousarray(a)  # (1,) for a 0-d array: the shape is put back below
    if not a.flags.writeable:  # e.g. np.asarray of a jax.Array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.reshape(shape).to(device)


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


def _tree(tree, device):
    """Nested dicts/lists of host arrays → the same structure of tensors."""
    if isinstance(tree, dict):
        return {k: _tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree(v, device) for v in tree]
    return _tensor(np.asarray(tree), device)


def dlrm_params_from_numpy(params, device="cuda"):
    """JAX ``init_dlrm``'s tree of host arrays → the port's DLRM parameters.

    ``{"tables": {name: (rows, dim)}, "bottom": [{"w", "b"}, ...], "top":
    [...]}`` keeps its structure and every array its layout, bit for bit:
    a dense ``w`` stays ``(d_in, d_out)`` (both packages compute
    ``x @ w + b``), so no transpose is made.
    """
    return _tree(params, device)


def lm_params_from_numpy(params, device="cuda"):
    """JAX ``init_lm``'s tree of host arrays → the port's LM parameters,
    bit for bit: the same nested dicts, layer parameters stacked on the
    leading ``L`` axis, dense weights ``(d_in, d_out)``."""
    return _tree(params, device)


def cache_from_numpy(cache, device="cuda"):
    """JAX ``init_cache``'s dict of host arrays (``k``, ``v``; int8 with
    bf16 ``k_scale``/``v_scale`` when quantized; the 0-d int32 ``len``;
    the recurrent families' state and the hybrid's nested ``mamba``,
    ``tail`` and ``shared`` ring) → the port's cache."""
    return _tree(cache, device)


_OPT_STATES = {cls._fields: cls for cls in (AdamWState, AdafactorState)}


def train_state_from_numpy(state, device="cuda") -> TrainState:
    """A JAX ``TrainState`` of host arrays (``jax.tree.map(np.asarray,
    state)``) → the port's :class:`~repro_torch.train.loop.TrainState`,
    bit for bit.  Its ``opt_state`` becomes the port's ``AdamWState``
    (fields ``step, mu, nu``) or ``AdafactorState`` (``step, vr, vc``),
    told apart by its fields; the steps stay 0-d int32."""
    opt = state.opt_state
    cls = _OPT_STATES.get(tuple(opt._fields))
    if cls is None:
        raise TypeError(f"unknown optimizer state with fields {opt._fields}")
    return TrainState(
        params=_tree(state.params, device),
        opt_state=cls(*(_tree(getattr(opt, f), device) for f in opt._fields)),
        step=_tensor(np.asarray(state.step), device),
    )


def train_state_to_numpy(state: TrainState) -> TrainState:
    """The port's ``TrainState`` → the same ``NamedTuple``s with NumPy
    leaves on the host, to rebuild the JAX package's state from.  bfloat16
    tensors come back widened to float32, which is exact:
    ``jnp.asarray(a, jnp.bfloat16)`` narrows them back bit for bit."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(host, state)
