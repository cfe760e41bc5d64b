"""Sharding rules: logical axes, spec derivation, sanitization, contexts.

The port of ``repro.dist.sharding`` over a torch ``DeviceMesh`` and
DTensor.  Every tensor of the LM is annotated with *logical* axis names
("batch", "mlp", "vocab", ...).  A rule table maps logical names to mesh
axes; specs derived from the table are *sanitized* against the actual
shapes (an axis that does not divide evenly falls back to replicated) so
one rule table serves every arch × shape cell.

Three layers, as in the reference:

  * **rule tables** — :data:`LOGICAL_RULES_SINGLE_POD` (16×16 data×model)
    and :data:`LOGICAL_RULES_MULTI_POD` (2×16×16 pod×data×model; the batch
    axis spans both pod and data).
  * **activation constraints** — :func:`maybe_shard` /
    :func:`maybe_shard_any` lay a tensor out as a DTensor *only* inside
    an :func:`activation_sharding_ctx`; outside a context they return
    their argument itself, so model code carries its annotations
    everywhere (unit tests, one device) without branching.  Inside a
    context they never change a value: a DTensor is redistributed, a
    plain tensor is taken as the replicated global value every SPMD rank
    holds and laid out the same way.
  * **parameter specs** — :func:`param_specs_for` derives a spec tree from
    parameter *names* (``wq/wk/wv/in_gate/w_gate/w_val`` are
    in-projections sharded (fsdp, tp); ``wo/w_out/out/down`` are
    out-projections sharded (tp, fsdp); ``embed``/``lm_head`` shard the
    vocab over model; norms, biases, scalar gates and routers replicate).

A spec is the port's own :class:`P`, a tuple of parts, each ``None``, a
mesh axis name or a tuple of axis names (JAX's ``PartitionSpec`` cannot
be imported here).  :func:`to_placements` turns a sanitized spec into
DTensor placements.  This module is the LM's mesh; the serving combine's
one-process-per-shard world is :mod:`repro_torch.dist.mesh`.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Rules = Dict[str, Any]  # logical axis name -> mesh axis | tuple | None


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))``.  One part per
    tensor dimension, each ``None``, a mesh axis name or a tuple of them
    (sharded over those axes, major first)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


# ---------------------------------------------------------------- rules --

_COMMON_RULES: Rules = {
    # activations
    "batch": "data",
    "seq": None,
    "embed": None,          # residual stream stays unsharded within a shard
    "expert_cap_dp": "data",
    # tensor parallelism
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "qgroups": "model",
    "vocab": "model",
    # parameters
    "fsdp": "data",
    # axes that never shard on these meshes
    "experts": None,
    "stage": None,
}

LOGICAL_RULES_SINGLE_POD: Rules = dict(_COMMON_RULES)

LOGICAL_RULES_MULTI_POD: Rules = dict(
    _COMMON_RULES,
    batch=("pod", "data"),
    expert_cap_dp=("pod", "data"),
)


def logical_to_spec(axes: Sequence[Optional[str]], rules: Rules) -> P:
    """Translates a tuple of logical axis names into a spec."""
    return P(*(rules.get(a) if a is not None else None for a in axes))


# ----------------------------------------------------------- sanitation --


def _mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a torch ``DeviceMesh``, or of a test fake
    carrying ``.axis_names`` + ``.devices`` (an ndarray whose shape is the
    mesh shape), as the reference's reads a JAX mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, np.shape(mesh.devices)))


def sanitize_spec(spec: Sequence, shape: Sequence[int], mesh) -> P:
    """Drops spec entries whose mesh-axis product does not divide the dim.

    Keeps the spec length (``P("model", None)`` sanitizes to
    ``P(None, None)``, not ``P()``), so specs stay positionally aligned
    with the rank they were written for.  A part naming a mesh axis the
    mesh does not carry (e.g. ``("pod", "data")`` on a single-pod mesh) is
    dropped too — treating an unknown axis as size 1 would let an invalid
    spec through to the layout.
    """
    sizes = _mesh_axis_sizes(mesh)
    out = []
    for d, part in enumerate(spec):
        if part is None:
            out.append(None)
            continue
        axes = part if isinstance(part, tuple) else (part,)
        known = all(a in sizes for a in axes)
        n = math.prod(sizes.get(a, 1) for a in axes)
        ok = known and d < len(shape) and n > 0 and shape[d] % n == 0
        out.append(part if ok else None)
    return P(*out)


def map_specs(fn, specs, *rest):
    """``fn(spec, *leaves)`` over a spec tree (nested dicts, lists, tuples
    and ``NamedTuple``s whose leaves are :class:`P`) and trees of the same
    structure; a :class:`P` is a leaf, not a tuple to walk."""
    if isinstance(specs, P):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], *(r[k] for r in rest)) for k in specs}
    if isinstance(specs, (list, tuple)):
        mapped = [map_specs(fn, *xs) for xs in zip(specs, *rest)]
        return type(specs)(*mapped) if hasattr(specs, "_fields") else type(specs)(mapped)
    return fn(specs, *rest)


def sanitize_specs_tree(specs, avals, mesh):
    """Maps :func:`sanitize_spec` over a (specs, avals) pair; an aval is
    anything with a ``.shape`` (a tensor, a meta tensor)."""
    return map_specs(lambda s, a: sanitize_spec(s, a.shape, mesh), specs, avals)


# ------------------------------------------------------------ placements --


def to_placements(spec: Sequence, mesh) -> List:
    """DTensor placements of a sanitized ``spec`` on ``mesh``: mesh dim
    ``i`` is ``Shard(d)`` when its axis appears in the part for tensor
    dim ``d``, ``Replicate()`` otherwise.  A tuple part shards one dim
    over several mesh dims, major axis first (JAX's order), which is
    DTensor's nesting when the part lists its axes in mesh order; any
    other order, or an axis in two parts, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    dim_of: Dict[str, int] = {}
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r} names {a!r}, not an axis of mesh {names}")
            if a in dim_of:
                raise ValueError(f"spec {spec!r} uses mesh axis {a!r} twice")
            dim_of[a] = d
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec part {part!r} is not in mesh order {names}: DTensor "
                             "nests a dim's shards in mesh-dim order")
    return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]


def place(x: torch.Tensor, mesh, placements: Sequence):
    """``x`` laid out with ``placements`` on ``mesh``: a DTensor is
    redistributed; a plain tensor is the replicated global value every
    rank holds, so no data moves (each rank keeps its chunk).
    Differentiable."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def shard_tensor(x: torch.Tensor, mesh, spec: Sequence):
    """``x`` laid out by the sanitized ``spec`` on ``mesh`` (:func:`place`)."""
    return place(x, mesh, to_placements(spec, mesh))


def replicated(x):
    """A DTensor redistributed to ``Replicate`` on every mesh dim (a
    ``Partial`` sum or mean reduced); anything else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return place(x, x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def placed_like(x, like):
    """``x`` redistributed to ``like``'s placements when ``like`` is a
    DTensor (a gradient to its parameter's layout); else ``x``."""
    from torch.distributed.tensor import DTensor

    if not isinstance(like, DTensor):
        return x
    return place(x, like.device_mesh, like.placements)


def gather_tree(tree):
    """Every DTensor leaf of ``tree`` as its full global tensor (a
    collective: every rank of the mesh calls it); other leaves as they
    are."""
    from torch.distributed.tensor import DTensor

    return _map_with_path(lambda _, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


# -------------------------------------------------- activation context --

_CTX = threading.local()


def _current() -> Tuple[Optional[Rules], Any]:
    """(rules, mesh) of the innermost activation context, (None, None) outside."""
    return getattr(_CTX, "state", (None, None))


@contextlib.contextmanager
def activation_sharding_ctx(mesh, rules: Rules):
    """Installs (mesh, rules) so :func:`maybe_shard` becomes active."""
    prev = _current()
    _CTX.state = (rules, mesh)
    try:
        yield
    finally:
        _CTX.state = prev


def maybe_shard(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Lays ``x`` out by the logical ``axes`` — ``x`` itself outside a context."""
    rules, mesh = _current()
    if mesh is None:
        return x
    spec = sanitize_spec(logical_to_spec(axes, rules), x.shape, mesh)
    return shard_tensor(x, mesh, spec)


def maybe_shard_any(
    x: torch.Tensor, candidates: Iterable[Sequence[Optional[str]]]
) -> torch.Tensor:
    """First candidate whose spec survives sanitization intact wins.

    Candidates are tried in order; one whose every requested axis divides
    the shape is applied.  If none fully applies, ``x`` is returned
    unconstrained (the conservative fallback — never a wrong sharding).
    """
    rules, mesh = _current()
    if mesh is None:
        return x
    for axes in candidates:
        spec = logical_to_spec(axes, rules)
        san = sanitize_spec(spec, x.shape, mesh)
        if san == spec:
            return shard_tensor(x, mesh, san)
    return x


# ------------------------------------------------------- parameter specs --

# name-pattern contract of the model zoo (exact leaf-name match):
#   in-projections  (..., d_in, d_out): fsdp on d_in, tp on d_out
#   out-projections (..., d_out, d_in): tp on d_out, fsdp on d_in
_IN_PROJ_NAMES = frozenset(
    {"wq", "wk", "wv", "wqkv", "qkv", "in_gate", "in", "up",
     "w_gate", "w_val", "w_in", "wi"}
)
_OUT_PROJ_NAMES = frozenset({"wo", "w_out", "out", "down"})


def _leaf_name(path: Sequence[str]) -> str:
    """The last dict key of a path (``NamedTuple`` fields and list indices
    are not keys, as in the reference's ``DictKey`` walk)."""
    for p in reversed(path):
        if p is not None:
            return str(p)
    return ""


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        mapped = [_map_with_path(fn, x, path + (None,)) for x in tree]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(path, tree)


def param_specs_for(params, rules: Rules, *, moe: bool = False):
    """Spec tree for a parameter tree, from leaf names alone.

    ``moe`` is accepted for call-site clarity; expert tensors are already
    covered by the name patterns (``w_gate``/``w_val``/``w_out`` with a
    leading expert dim that maps to the "experts" rule, None on these
    meshes) and routers replicate.
    """
    del moe  # name patterns cover the expert layout
    fsdp = rules.get("fsdp", "data")
    tp = rules.get("mlp", "model")
    vocab = rules.get("vocab", "model")

    def spec(path, leaf) -> P:
        name = _leaf_name(path)
        rank = len(leaf.shape)
        if rank < 2:
            return P()
        lead = [None] * (rank - 2)
        if name in _IN_PROJ_NAMES:
            return P(*lead, fsdp, tp)
        if name in _OUT_PROJ_NAMES:
            return P(*lead, tp, fsdp)
        if name == "embed":
            return P(*lead, vocab, fsdp)
        if name == "lm_head":
            return P(*lead, fsdp, vocab)
        return P()

    return _map_with_path(spec, params)


def distribute_tree(tree, specs, mesh):
    """Every leaf of ``tree`` (the same global value on every rank) laid out
    on ``mesh`` by its spec in ``specs``; a spec shorter than the leaf's
    rank leaves the other dims replicated."""
    return map_specs(lambda s, x: shard_tensor(x, mesh, s).detach(), specs, tree)


def replicate_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` (a plain tensor every rank computes alike: positions, masks)
    as a replicated DTensor on ``like``'s mesh when ``like`` is a DTensor,
    else ``t`` itself: DTensor ops refuse plain operands of more than one
    element."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(like, DTensor):
        return t
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def replicated_local(fn, *xs, outputs: int = 1):
    """``fn(*xs)`` on full copies: every DTensor operand is replicated and
    ``fn`` runs on its local tensor (plain operands as they are), each of
    its ``outputs`` tensors a replicated DTensor (``local_map``); gradients
    flow back the same way.  Without DTensor operands it is ``fn(*xs)``.

    For the gathers whose backward DTensor cannot shard on torch 2.11:
    ``index_put`` (an index's backward) fails to normalize its shard
    dims, and ``topk``'s backward scatters into a plain zero tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = next((x.device_mesh for x in xs if isinstance(x, DTensor)), None)
    if mesh is None:
        return fn(*xs)
    rep = [Replicate()] * mesh.ndim
    ins = (rep,) * len(xs)
    # local_map reads a tuple as one placement list an output, a list as
    # the one output's
    return local_map(fn, out_placements=rep if outputs == 1 else (rep,) * outputs,
                     in_placements=ins, in_grad_placements=ins, redistribute_inputs=True)(*xs)


def batch_local(fn, shared, *batched):
    """``fn(shared, *batched)`` on each rank's slice of the batch.

    Outside an activation context, or with no DTensor argument, it is that
    call itself.  Inside one, every tensor of the pytree ``shared`` (the
    parameters) is given whole to every rank, and each of ``batched``
    (tensors whose dim 0 is the batch; ``None`` passes through) as the
    rank's slice over the rules' ``"batch"`` axes, sanitized against the
    batch of ``batched[0]``; every tensor ``fn`` returns is taken as that
    rank's slice of a batch-sharded DTensor.  Gradients flow back the same
    way: a parameter's as a partial sum over the batch axes.  The other
    mesh axes compute the same slice alike, so no collective runs inside
    ``fn``: the recurrent scans, whose per-step DTensor dispatch would be
    slow and whose batch dim is the only one the data axes shard."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.utils._pytree import tree_flatten, tree_unflatten

    rules, mesh = _current()
    flat, spec = tree_flatten((shared, batched))
    if mesh is None or not any(isinstance(x, DTensor) for x in flat):
        return fn(shared, *batched)
    dims = to_placements(sanitize_spec(logical_to_spec(("batch",), rules),
                                       (batched[0].shape[0],), mesh), mesh)
    rep = [Replicate()] * mesh.ndim
    partial = [Partial() if p == Shard(0) else Replicate() for p in dims]
    n_shared = len(tree_flatten(shared)[0])
    local = [x if not isinstance(x, torch.Tensor) else
             place(x, mesh, rep if i < n_shared else dims).to_local(
                 grad_placements=partial if i < n_shared else dims)
             for i, x in enumerate(flat)]
    shared_l, batched_l = tree_unflatten(local, spec)
    out, out_spec = tree_flatten(fn(shared_l, *batched_l))
    return tree_unflatten([DTensor.from_local(o, mesh, dims, run_check=False)
                           if isinstance(o, torch.Tensor) else o for o in out], out_spec)


def shard_index(mesh, dims: Sequence[int]) -> Tuple[int, int]:
    """``(index, count)`` of this rank's shard of a tensor dim split over
    the mesh dims ``dims``, major first (DTensor's nesting)."""
    index, count = 0, 1
    for i in dims:
        index = index * mesh.size(i) + mesh.get_local_rank(i)
        count *= mesh.size(i)
    return index, count
