"""Train-step builders: autograd + optimizer + microbatching.

The port of ``repro.train.loop``.  ``make_train_step`` returns a function
of ``(state, batch)`` that computes the loss and its gradients with
autograd and applies the optimizer's functional update.  With
``microbatches > 1`` the batch is split along its leading dimension and
``g / microbatches`` is accumulated in ``accum_dtype`` in order, one
microbatch after another, as the reference's ``lax.scan`` does.  The
reported ``grad_norm`` is the norm of the unclipped gradients; the clip
happens inside ``optimizer.update``.  With ``has_enc`` (the vlm family)
the batch's ``enc`` image embeddings go to the loss, split along the
batch with the tokens.

On a device mesh the parameters and the optimizer state are DTensors
(made off the mesh and laid out by ``dist.sharding``'s specs, as the
reference's elastic example lays out its state) and the batch is laid
out by ``launch.dryrun.batch_specs``; the step runs inside an
``activation_sharding_ctx``.  The gradients keep the parameters'
placements, and ``loss`` and ``grad_norm`` come back as replicated 0-d
DTensors.  A state that lives on a mesh is the switch; there is no flag.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import placed_like, replicated
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.transformer import lm_loss
from repro_torch.train.tree import global_norm


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def init_train_state(params, optimizer) -> TrainState:
    return TrainState(
        params=params,
        opt_state=optimizer.init(params),
        step=torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device),
    )


def _value_and_grad(cfg: ModelConfig, params, tokens, labels, enc, remat: bool):
    """``(loss, grads)`` of ``lm_loss`` at ``params``; ``grads`` has the
    structure and dtypes of ``params``."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = lm_loss(live, cfg, tokens, labels, enc=enc, remat=remat)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return replicated(loss.detach()), tree_map(lambda p: placed_like(next(grads), p), params)

def make_train_step(
    cfg: ModelConfig,
    optimizer,
    *,
    remat: bool = False,
    microbatches: int = 1,
    has_enc: bool = False,
    accum_dtype=torch.float32,
) -> Callable:
    """Builds ``train_step(state, batch) -> (state, metrics)``.

    ``batch = {"tokens": ..., "labels": ...[, "enc": ...]}``, tensors on
    the parameters' device (``enc`` is read only with ``has_enc``); the
    leading batch dim must be divisible by ``microbatches``.  ``metrics``
    holds 0-d float32 device tensors ``loss`` and ``grad_norm``.

    Microbatch ``i`` is the ``i``-th contiguous slice of the batch; on a
    mesh (a DTensor batch) it is rows ``i, i + m, …`` of each rank's own
    slice, so no row moves between ranks: the same mean gradient, summed
    in another order.
    """

    def train_step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        tokens, labels = batch["tokens"], batch["labels"]
        enc = batch.get("enc") if has_enc else None
        if microbatches == 1:
            loss, grads = _value_and_grad(cfg, state.params, tokens, labels, enc, remat)
        else:
            if tokens.shape[0] % microbatches:
                raise ValueError(f"batch {tokens.shape[0]} is not divisible by "
                                 f"microbatches={microbatches}")

            def split(x):
                if hasattr(x, "placements"):
                    return x.reshape(-1, microbatches, *x.shape[1:]).transpose(0, 1)
                return x.reshape(microbatches, -1, *x.shape[1:])

            tk, lb = split(tokens), split(labels)
            ec = split(enc) if enc is not None else [None] * microbatches
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=accum_dtype), state.params)
            for i in range(microbatches):
                l, g = _value_and_grad(cfg, state.params, tk[i], lb[i], ec[i], remat)
                loss = loss + l / microbatches
                grads = tree_map(lambda a, b: a + (b / microbatches).to(a.dtype), grads, g)
                del g

        new_params, new_opt = optimizer.update(grads, state.opt_state, state.params)
        metrics = {"loss": loss.float(), "grad_norm": global_norm(grads)}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, has_enc: bool = False) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        enc = batch.get("enc") if has_enc else None
        return lm_loss(params, cfg, batch["tokens"], batch["labels"], enc=enc)

    return eval_step
