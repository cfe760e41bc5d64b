"""Optimizers and LR schedules of the port: functional, on parameter trees.

The port of ``repro.train.optimizer``.  ``update`` returns new trees and a
new state, as in JAX, and never writes its arguments.  The step is a 0-d
int32 tensor on the parameters' device; schedules take it as float32 and
return a 0-d float32 tensor, as ``jnp`` computes them, so the learning
rate never goes through the host.

* AdamW — float32 moments, decoupled weight decay, global-norm clipping
  inside ``update``, bias correction in float32.
* Adafactor — factored second moment over the last two dimensions,
  momentum-free, update clipping by the RMS over the whole leaf.
* Schedules: cosine and WSD (warmup-stable-decay).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.train.tree import global_norm, map_n


# ------------------------------------------------------------ schedules --

def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, stable: int, total: int) -> Callable:
    """Warmup-Stable-Decay (MiniCPM): flat plateau then sharp decay tail."""
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        decay_len = max(total - warmup - stable, 1)
        prog = torch.clamp((step - warmup - stable) / decay_len, 0.0, 1.0)
        decay = base_lr * (1.0 - prog) ** 2
        out = torch.where(step < warmup, warm, base_lr)
        return torch.where(step < warmup + stable, out, decay)
    return lr


def make_schedule(kind: str, base_lr: float, total: int, *, warmup: int = 0) -> Callable:
    warmup = warmup or max(total // 100, 10)
    if kind == "wsd":
        return wsd_schedule(base_lr, warmup, int(total * 0.8), total)
    return cosine_schedule(base_lr, warmup, total)


def _zero_step(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


# ---------------------------------------------------------------- AdamW --

class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: Callable
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Any = torch.float32

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=self.moment_dtype, device=p.device)
        return AdamWState(step=_zero_step(params), mu=tree_map(zeros, params),
                          nu=tree_map(zeros, params))

    def update(self, grads, state: AdamWState, params) -> Tuple[Any, AdamWState]:
        grads = clip_by_global_norm(grads, self.clip_norm)
        step = state.step + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** _f32(step)
        bc2 = 1 - b2 ** _f32(step)

        def upd(p, g, m, v):
            m = b1 * m + (1 - b1) * g.to(m.dtype)
            v = b2 * v + (1 - b2) * torch.square(g.to(v.dtype))
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps) + self.weight_decay * p.to(m.dtype)
            return (p.float() - lr * delta).to(p.dtype), m, v

        new_params, mu, nu = map_n(upd, 3, params, grads, state.mu, state.nu)
        return new_params, AdamWState(step=step, mu=mu, nu=nu)


# ------------------------------------------------------------ Adafactor --

class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any      # row second-moment factors (or full v for <2D leaves)
    vc: Any      # col factors (zeros for <2D leaves)


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored AdaGrad-style optimizer (Shazeer & Stern), momentum-free.

    The second moment of an ``(r, c)`` matrix is stored as ``(r,)`` +
    ``(c,)`` factors; >2-D leaves factor over the trailing two dims.  The
    update is clipped by its RMS over the whole leaf, so a leaf is updated
    in one piece.
    """

    schedule: Callable
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params) -> AdafactorState:
        def vr_init(p):
            shape = p.shape[:-1] if p.ndim >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vc_init(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else ()
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(step=_zero_step(params), vr=tree_map(vr_init, params),
                              vc=tree_map(vc_init, params))

    def update(self, grads, state: AdafactorState, params):
        step = state.step + 1
        t = _f32(step)
        beta = 1.0 - t ** (-self.decay)
        lr = self.schedule(step)

        def upd(p, g, vr, vc):
            g = g.float()
            g2 = torch.square(g) + self.eps
            if p.ndim >= 2:
                vr = beta * vr + (1 - beta) * g2.mean(dim=-1)
                vc = beta * vc + (1 - beta) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)[..., None]
                prec = (vr[..., None] / denom) * vc[..., None, :]
                u = g * torch.rsqrt(prec + self.eps)
            else:
                vr = beta * vr + (1 - beta) * g2
                u = g * torch.rsqrt(vr + self.eps)
            # update clipping (RMS(u) <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + self.eps)
            u = u / torch.clamp_min(rms / self.clip_threshold, 1.0)
            newp = p.float() - lr * (u + self.weight_decay * p.float())
            return newp.to(p.dtype), vr, vc

        new_p, vr, vc = map_n(upd, 3, params, grads, state.vr, state.vc)
        return new_p, AdafactorState(step=step, vr=vr, vc=vc)


# ---------------------------------------------------------------- utils --

def clip_by_global_norm(grads, max_norm: float):
    """Scales every leaf by ``min(1, max_norm / max(norm, 1e-9))`` in
    float32; the norm sums the leaves in JAX's order."""
    norm = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


def make_optimizer(kind: str, schedule: Callable, **kw):
    if kind == "adamw":
        return AdamW(schedule=schedule, **kw)
    if kind == "adafactor":
        return Adafactor(schedule=schedule, **kw)
    raise ValueError(f"unknown optimizer {kind!r}")
