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

``apply_moe_shardmap`` outside a mesh is ``apply_moe(p, x, moe, act)``
in the reference; the port has no LM mesh, so it is always that.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import Params, _trunc_normal, dense_init


def init_moe(generator: torch.Generator, d_model: int, d_ff: int, moe: MoEConfig, act: str,
             dtype) -> Params:
    """JAX's leaves and shapes: ``router`` float32 ``(d, E)``,
    ``w_gate``/``w_val`` ``(E, d, f)``, ``w_out`` ``(E, f, d)``."""
    E = moe.num_experts
    p: Params = {
        "router": dense_init(generator, d_model, E, torch.float32),  # router in f32
        "w_out": _trunc_normal(generator, (E, d_ff, d_model), 0.5 / math.sqrt(d_ff), dtype),
        "w_val": _trunc_normal(generator, (E, d_model, d_ff), 1.0 / math.sqrt(d_model), dtype),
    }
    if act in ("swiglu", "geglu"):
        p["w_gate"] = _trunc_normal(generator, (E, d_model, d_ff), 1.0 / math.sqrt(d_model),
                                    dtype)
    return p


def apply_moe(
    p: Params,
    x: torch.Tensor,          # (b, s, d)
    moe: MoEConfig,
    act: str = "swiglu",
    *,
    num_groups: int = 1,
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
    top_w, top_e = torch.topk(probs, k, dim=-1)              # descending, as lax.top_k
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
    onehot = (flat_e[:, None, :] == torch.arange(E, device=x.device)[:, None]).to(torch.int32)
    # load-balancing aux loss (Switch): E * Σ_e f_e · P_e, f_e the share of
    # choices routed to e (counted without a host sync)
    f = onehot.sum(dim=(0, 2)).float() / (T * k)
    aux = E * torch.sum(f * probs.mean(dim=0))
    position = torch.gather(onehot.cumsum(dim=2), 1, flat_e[:, None, :])[:, 0] - 1
    keep = position < Cg
    position = torch.where(keep, position, Cg - 1) + (
        torch.arange(G, device=x.device)[:, None] * Cg)
    flat_e, position, keep = flat_e.reshape(-1), position.reshape(-1), keep.reshape(-1)
    tok_idx = torch.arange(T, device=x.device).repeat_interleave(k)

    # dispatch: the kept rows assigned to their slots, dropped ones to the
    # spare slot C of their expert (sliced away below)
    rows = flat_e * (C + 1) + torch.where(keep, position, C)
    buf = torch.zeros((E * (C + 1), d), dtype=x.dtype, device=x.device)
    buf = buf.index_copy(0, rows, xt[tok_idx]).reshape(E, C + 1, d)[:, :C]

    # expert FFN: batched matmuls over the expert axis
    if "w_gate" in p:
        gate = torch.bmm(buf, p["w_gate"])
        gate = F.silu(gate) if act == "swiglu" else F.gelu(gate, approximate="tanh")
        h = gate * torch.bmm(buf, p["w_val"])
    else:
        h = F.gelu(torch.bmm(buf, p["w_val"]), approximate="tanh")
    out_buf = torch.bmm(h, p["w_out"]).reshape(E * C, d)     # (E, C, d)

    # combine: each choice's result (slot Cg-1 times 0 when dropped, as
    # JAX gathers it), weighted, summed over k in order in the dtype
    gathered = out_buf[flat_e * C + position] * keep[:, None].to(x.dtype)
    weighted = (gathered * top_w.reshape(T * k, 1).to(x.dtype)).reshape(T, k, d)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + weighted[:, j]
    return y.reshape(b, s, d), aux


def apply_moe_shardmap(
    p: Params,
    x: torch.Tensor,
    moe: MoEConfig,
    act: str = "swiglu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_impl == "shardmap"``: the reference's shard-local dispatch over
    the data axes of an LM mesh, which outside a mesh is
    ``apply_moe(p, x, moe, act)`` (no ``num_groups``).  The port has no LM
    mesh yet, so it is always that; the shard-local form waits for the
    port of ``dist/sharding.py`` (ROADMAP.md, Queue 1 item 4)."""
    return apply_moe(p, x, moe, act)


def moe_flops_per_token(d_model: int, d_ff: int, moe: MoEConfig, act: str) -> int:
    """Active FLOPs per token (for 6ND-style accounting)."""
    mats = 3 if act in ("swiglu", "geglu") else 2
    return 2 * mats * d_model * d_ff * moe.top_k
