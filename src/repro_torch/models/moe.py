"""Mixture-of-Experts FFN with sort-free capacity dispatch.

The port of ``repro.models.moe``.  For each token's top-k choice the
position inside its expert's buffer comes from a cumulative sum over the
(tokens, experts) routing one-hot; tokens go into per-expert buffers
``(E, C, d)``, the experts run as batched matmuls over the expert axis
(``torch.bmm``, as the reference computes them outside any kernel), and
each token's choices are combined with its router weights.  Capacity
``Cg = max(ceil(Tg·k·cf/E), 8)`` per group; overflow choices drop.

Two places follow the reference's arithmetic by another route:

* **dispatch**: JAX scatter-ADDS every choice into a zero buffer, a
  dropped one as exact zeros at slot ``Cg-1``.  Kept choices have unique
  ``(expert, slot)`` pairs, so the same buffer is an index ASSIGNMENT of
  the kept rows; here dropped rows are assigned to one extra slot per
  expert past ``C`` that is sliced away.  No ``index_add_``/accumulating
  ``index_put_`` (atomics on CUDA), so the buffer is deterministic and
  bit-equal to JAX's add.
* **combine**: XLA's scatter adds a token's k weighted choices in order,
  in the model dtype; here ``y = y + w[:, j]`` for ``j`` in order, not
  ``.sum(dim=1)`` (which accumulates in float32 and rounds once).

Inside an :func:`~repro_torch.dist.sharding.activation_sharding_ctx` the
buffers are laid out by ``_BUF_SHARDINGS``/``_HID_SHARDINGS`` (under
``shard_buffers``), and ``apply_moe_shardmap`` keeps the dispatch and
the combine on each data shard; outside one it is
``apply_moe(p, x, moe, act)``, as in the reference.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.dist.sharding import (
    P, _current, maybe_shard_any, replicate_like, replicated, replicated_local, sanitize_spec,
    shard_tensor,
)
from repro_torch.models.layers import Params, _trunc_normal, dense_init

# dispatch/combine buffers: shard capacity over data (token parallelism
# follows the batch), expert dim over model when it divides, else keep
# experts local and let the f-dim TP inside the matmul carry the model axis
_BUF_SHARDINGS = (
    ("experts", "expert_cap_dp", None),
    (None, "expert_cap_dp", None),
)
_HID_SHARDINGS = (
    ("experts", "expert_cap_dp", "mlp"),
    (None, "expert_cap_dp", "mlp"),
)


def init_moe(generator: torch.Generator, d_model: int, d_ff: int, moe: MoEConfig, act: str,
             dtype, *, device=None) -> Params:
    """JAX's leaves and shapes: ``router`` float32 ``(d, E)``,
    ``w_gate``/``w_val`` ``(E, d, f)``, ``w_out`` ``(E, f, d)``."""
    E = moe.num_experts
    p: Params = {
        "router": dense_init(generator, d_model, E, torch.float32, device=device),  # f32
        "w_out": _trunc_normal(generator, (E, d_ff, d_model), 0.5 / math.sqrt(d_ff), dtype,
                               device),
        "w_val": _trunc_normal(generator, (E, d_model, d_ff), 1.0 / math.sqrt(d_model), dtype,
                               device),
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = _trunc_normal(generator, (E, d_model, d_ff), 1.0 / math.sqrt(d_model),
                                    dtype, device)
    return p


def apply_moe(
    p: Params,
    x: torch.Tensor,          # (b, s, d)
    moe: MoEConfig,
    act: str = "swiglu",
    *,
    num_groups: int = 1,
    shard_buffers: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(y (b, s, d), aux_loss)``, the Switch load-balancing loss
    a float32 scalar.

    ``num_groups > 1`` splits the tokens into that many contiguous groups,
    each with its own capacity ``Cg`` and cumulative sum (group-local
    dispatch); a ``num_groups`` that does not divide the token count
    falls back to one group, as in the reference.
    """
    b, s, d = x.shape
    E, k = moe.num_experts, moe.top_k
    T = b * s
    xt = x.reshape(T, d)

    logits = xt.float() @ p["router"]                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # descending, as lax.top_k; on a mesh over replicated probabilities
    # (replicated_local: DTensor cannot shard topk's backward)
    top_w, top_e = replicated_local(lambda pr: tuple(torch.topk(pr, k, dim=-1)), probs,
                                    outputs=2)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    G = num_groups if T % num_groups == 0 else 1
    Tg = T // G
    Cg = max(int(math.ceil(Tg * k * moe.capacity_factor / E)), 8)
    C = G * Cg

    # position of each (token, choice) inside its expert's buffer, counted
    # within its group; group g owns buffer rows [g*Cg, (g+1)*Cg)
    # (the routing one-hot is laid out (G, E, Tg*k), so the running count
    # scans the innermost axis)
    flat_e = top_e.reshape(G, Tg * k)
    experts = replicate_like(torch.arange(E, device=x.device)[:, None], x)
    onehot = (flat_e[:, None, :] == experts).to(torch.int32)
    # load-balancing aux loss (Switch): E * Σ_e f_e · P_e, f_e the share of
    # choices routed to e (counted without a host sync)
    f = onehot.sum(dim=(0, 2)).float() / (T * k)
    aux = E * torch.sum(f * probs.mean(dim=0))
    position = torch.gather(onehot.cumsum(dim=2), 1, flat_e[:, None, :])[:, 0] - 1
    keep = position < Cg
    position = torch.where(keep, position, Cg - 1) + (
        replicate_like(torch.arange(G, device=x.device)[:, None] * Cg, x))
    flat_e, position, keep = flat_e.reshape(-1), position.reshape(-1), keep.reshape(-1)
    tok_idx = replicate_like(torch.arange(T, device=x.device).repeat_interleave(k), x)

    # dispatch: the kept rows assigned to their slots, dropped ones to the
    # spare slot C of their expert (sliced away below)
    rows = flat_e * (C + 1) + torch.where(keep, position, C)
    buf = replicate_like(torch.zeros((E * (C + 1), d), dtype=x.dtype, device=x.device), x)
    buf = buf.index_copy(0, rows, replicated_local(_rows, xt, tok_idx)).reshape(E, C + 1, d)[:, :C]
    if shard_buffers:
        buf = maybe_shard_any(buf, _BUF_SHARDINGS)

    # expert FFN: batched matmuls over the expert axis
    if "w_gate" in p:
        gate = torch.bmm(buf, p["w_gate"])
        gate = F.silu(gate) if act == "swiglu" else F.gelu(gate, approximate="tanh")
        h = gate * torch.bmm(buf, p["w_val"])
    else:
        h = F.gelu(torch.bmm(buf, p["w_val"]), approximate="tanh")
    if shard_buffers:
        h = maybe_shard_any(h, _HID_SHARDINGS)
    out_buf = torch.bmm(h, p["w_out"])                       # (E, C, d)
    if shard_buffers:
        # laid out as the reference lays it out, then replicated: the flat
        # view below merges the expert and capacity dims, and DTensor
        # (torch 2.11) cannot flatten the sharded capacity dim
        out_buf = replicated(maybe_shard_any(out_buf, _BUF_SHARDINGS))
    out_buf = out_buf.reshape(E * C, d)

    # combine: each choice's result (slot Cg-1 times 0 when dropped, as
    # JAX gathers it), weighted, summed over k in order in the dtype
    gathered = replicated_local(_rows, out_buf, flat_e * C + position) * keep[:, None].to(x.dtype)
    weighted = (gathered * top_w.reshape(T * k, 1).to(x.dtype)).reshape(T, k, d)
    y = replicate_like(torch.zeros((T, d), dtype=x.dtype, device=x.device), x)
    for j in range(k):
        y = y + weighted[:, j]
    return y.reshape(b, s, d), aux


def _rows(table, idx):
    """``table[idx]``: under ``replicated_local`` on a mesh, since DTensor
    cannot shard an index's backward (``index_put``)."""
    return table[idx]


def apply_moe_shardmap(
    p: Params,
    x: torch.Tensor,          # (b, s, d), batch-sharded over the dp axes
    moe: MoEConfig,
    act: str = "swiglu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_impl == "shardmap"``: the dispatch is SHARD-LOCAL over the data
    axes (``rules["batch"]``) of the activation context's mesh.

    Each data shard routes, dispatches, runs the experts and combines its
    own batch slice with :func:`apply_moe` (``shard_buffers=False``) under
    ``local_map``, so the token→expert scatter and the expert→token
    combine never leave the shard.  The FSDP shards of the expert weights
    are all-gathered once per call (dim 1 of ``w_gate``/``w_val``, dim 2
    of ``w_out``); their f dim keeps its tensor-parallel split over the
    other axes, so each rank computes its slice of the hidden layer and
    ``y`` comes out as a partial sum over those axes.  ``aux`` is the mean
    of the shards' losses over the dp axes: the reference's ``pmean`` over
    the last dp axis on a single-pod mesh; on a multi-pod one the
    reference's value differs from pod to pod, and the port takes the mean
    over every dp shard, the one value every rank agrees on.  A batch the
    dp axes do not divide raises ``ValueError``, as the reference's
    ``shard_map`` refuses its ``in_specs``.

    Outside a context it is ``apply_moe(p, x, moe, act)``.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rules, mesh = _current()
    if mesh is None:
        return apply_moe(p, x, moe, act)
    dp = rules.get("batch", "data")
    x_spec = P(dp, None, None)
    if sanitize_spec(x_spec, x.shape, mesh) != x_spec:
        raise ValueError(f"apply_moe_shardmap: x of shape {tuple(x.shape)} cannot be split "
                         f"by {x_spec} over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    names = list(mesh.mesh_dim_names)
    dp_dims = {names.index(a) for a in (dp if isinstance(dp, tuple) else (dp,))}

    def gather_dp(w, f_dim):
        # the all-gather of the FSDP shards; the f dim keeps its TP split
        tp = tuple(a for i, a in enumerate(names) if i not in dp_dims
                   and isinstance(w, DTensor) and w.placements[i] == Shard(f_dim))
        spec = [None] * w.ndim
        spec[f_dim] = (tp if len(tp) > 1 else tp[0]) if tp else None
        return shard_tensor(w, mesh, P(*spec))

    keys = [k for k in ("w_gate", "w_val", "w_out") if k in p]
    ws = [gather_dp(p[k], 1 if k == "w_out" else 2) for k in keys]
    ws.append(shard_tensor(p["router"], mesh, P()))
    x_d = shard_tensor(x, mesh, x_spec)
    # where the f dim is split each rank computes a slice of the hidden
    # layer: y, and the gradients of x and the router, are partial sums
    tp_dims = {i for i, pl in enumerate(ws[keys.index("w_out")].placements) if pl == Shard(1)}
    parts = dp_dims | tp_dims

    def grad_placements(t):
        # a replicated input's gradient differs across the dp shards (other
        # tokens) and the tp shards (other hidden slices)
        return tuple(pl if isinstance(pl, Shard) else Partial() if i in parts else Replicate()
                     for i, pl in enumerate(t.placements))

    def local(xl, *wl):
        y, aux = apply_moe(dict(zip(keys + ["router"], wl)), xl, moe, act,
                           shard_buffers=False)
        # aux: the mean of the dp shards' losses; each tp rank holds the
        # same value, so it enters the (partial) gradients once, split evenly
        return y, aux / math.prod(mesh.size(i) for i in parts)

    ins = (x_d, *ws)
    y, aux = local_map(
        local, out_placements=(grad_placements(x_d), tuple(
            Partial() if i in parts else Replicate() for i in range(mesh.ndim))),
        in_placements=tuple(t.placements for t in ins),
        in_grad_placements=tuple(grad_placements(t) for t in ins))(*ins)
    return y, aux.redistribute(mesh, [Replicate()] * mesh.ndim)


def moe_flops_per_token(d_model: int, d_ff: int, moe: MoEConfig, act: str) -> int:
    """Active FLOPs per token (for 6ND-style accounting)."""
    mats = 3 if act in ("swiglu", "geglu") else 2
    return 2 * mats * d_model * d_ff * moe.top_k
