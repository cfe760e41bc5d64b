"""Parameter trees in JAX's order: leaf names, the global norm, and maps
with several outputs a leaf.

``jax.tree_util`` walks a dict's keys in sorted order, a ``NamedTuple``'s
fields and a list's items in order, and spells a path with each dict key
bare, each field as ``.name`` and each list index as its number, joined
by ``/`` (``repro.train.checkpoint._flatten_with_names``).  The port's
trees keep their insertion order (``repro_torch.models.layers.
tree_leaves``); the train package walks them in JAX's order wherever the
order shows: in checkpoint names, and in the float32 sum of the global
gradient norm.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from repro_torch.dist.sharding import replicated
from repro_torch.models.layers import tree_map


def flatten_with_names(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(name, leaf)]`` in JAX's order and spelling."""

    def join(part):
        return f"{prefix}/{part}" if prefix else part

    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten_with_names(tree[k], join(str(k)))]
    if hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in flatten_with_names(getattr(tree, f), join(f".{f}"))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in flatten_with_names(x, join(str(i)))]
    return [(prefix, tree)]


def map_with_names(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """``fn(name, leaf)`` over the leaves, names spelled as
    :func:`flatten_with_names` spells them; the result keeps ``tree``'s
    structure, dict order included."""

    def join(part):
        return f"{prefix}/{part}" if prefix else part

    if isinstance(tree, dict):
        return {k: map_with_names(fn, v, join(str(k))) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(map_with_names(fn, getattr(tree, f), join(f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_names(fn, x, join(str(i))) for i, x in enumerate(tree))
    return fn(prefix, tree)


def jax_leaves(tree: Any) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in flatten_with_names(tree)]


def global_norm(tree: Any) -> torch.Tensor:
    """``sqrt(Σ Σ g²)`` in float32, the leaves summed in JAX's order.  Over
    DTensor leaves the sums reduce over the whole mesh and the norm is a
    replicated 0-d DTensor."""
    return replicated(torch.sqrt(sum(g.float().square().sum() for g in jax_leaves(tree))))


def map_n(fn: Callable, n: int, tree: Any, *rest) -> tuple:
    """``fn`` over the leaves of ``tree`` and ``rest``, returning ``n``
    values a leaf: ``n`` trees of ``tree``'s structure.  One leaf is
    finished before the next starts, so temporaries stay at one leaf's
    size."""
    outs = []
    tree_map(lambda *xs: outs.append(fn(*xs)), tree, *rest)
    its = [iter([o[i] for o in outs]) for i in range(n)]
    return tuple(tree_map(lambda _, it=it: next(it), tree) for it in its)
