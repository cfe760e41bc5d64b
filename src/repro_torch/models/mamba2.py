"""Mamba2 (SSD) block: the chunked state-space duality form and its
one-token recurrence.

The port of ``repro.models.mamba2``.  The selective state-space
recurrence

    h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t          (A scalar per head, SSD)
    y_t = C_t · h_t + D x_t

is computed chunk by chunk (``chunk`` steps): within a chunk as the
masked quadratic form, across chunks by carrying the float32 state
``(b, heads, head_dim, N)``; JAX's ``lax.scan`` over the chunks is a
Python loop.  :func:`mamba2_decode_step` is the O(1) recurrence.  Shapes
follow Mamba2: ``d_inner = 2·d_model``, heads of ``head_dim``, state size
``N = ssm_state``, a depthwise causal conv of width ``CONV_W``, and the
gated RMSNorm (eps 1e-6, its own, not ``apply_norm``) before the output
projection.

As in the reference, the causal mask is applied to the log decays before
their ``exp`` (an ``exp`` of the masked, positive entries would overflow
and poison the gradient through the ``where`` as ``inf · 0``), the conv's
four products are summed in order in the model dtype, ``C_t · B_t'`` is
a product in the model dtype, the other products with the float32 state
widen ``B`` and ``C`` to float32 (JAX's type promotion), and ``D`` is
cast to the model dtype before ``xh · D``.  ``softplus`` is
``F.softplus(x, beta=1, threshold=20)``: past 20 it returns ``x`` where
JAX computes ``logaddexp(x, 0)``, which differs there by less than
``exp(-20) ≈ 2.1e-9``, below float32's ulp at 20.

On a device mesh the two projections (``w_in``, ``w_out``) run as their
tensors are laid out, tensor- and FSDP-parallel, and the conv, the SSD
chunks and the gated norm on each rank's batch slice
(``dist.sharding.batch_local``), so no rank gathers a layer's weights.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import batch_local
from repro_torch.models.layers import Params, _trunc_normal, dense_init, on_device

CONV_W = 4


def init_mamba2(generator: torch.Generator, d_model: int, ssm_state: int, dtype, *,
                head_dim: int = 64, device=None) -> Params:
    d_inner = 2 * d_model
    heads = d_inner // head_dim
    N = ssm_state
    device = on_device(generator, device)
    return {
        # fused input projection: [x, z, B, C, dt]
        "w_in": dense_init(generator, d_model, 2 * d_inner + 2 * N + heads, dtype, device=device),
        "conv": _trunc_normal(generator, (CONV_W, d_inner), 0.2, dtype, device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, heads, device=device)).float(),
        "D": torch.ones((heads,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((heads,), dtype=torch.float32, device=device),
        "w_out": dense_init(generator, d_inner, d_model, dtype, scale=0.5, device=device),
        "norm_scale": torch.ones((d_inner,), dtype=dtype, device=device),
    }


def _split_proj(proj, d_inner, N, heads):
    """``(x, z, B, C, dt)`` of the fused input projection."""
    return torch.split(proj, [d_inner, d_inner, N, N, heads], dim=-1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv of width ``CONV_W``.  x: ``(b, s, d)``; state:
    ``(b, CONV_W-1, d)``, the last inputs before ``x`` (zeros when None).
    Returns ``(out, new_state)``."""
    if state is None:
        state = torch.zeros((x.shape[0], CONV_W - 1, x.shape[-1]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(CONV_W))
    return out, xp[:, -(CONV_W - 1):]


def _gated_rmsnorm(p: Params, y: torch.Tensor, z: torch.Tensor, dtype) -> torch.Tensor:
    yf = y.float()
    y = (yf * torch.rsqrt(yf.square().mean(dim=-1, keepdim=True) + 1e-6)).to(dtype)
    return y * p["norm_scale"] * F.silu(z)


def _softplus_dt(dt: torch.Tensor, p: Params) -> torch.Tensor:
    return F.softplus(dt.float() + p["dt_bias"], beta=1, threshold=20)


def apply_mamba2(
    p: Params,
    u: torch.Tensor,              # (b, s, d_model)
    *,
    ssm_state: int,
    head_dim: int = 64,
    chunk: int = 128,
) -> torch.Tensor:
    y, _ = mamba2_scan(p, u, ssm_state=ssm_state, head_dim=head_dim, chunk=chunk)
    return y


def mamba2_scan(
    p: Params,
    u: torch.Tensor,
    *,
    ssm_state: int,
    head_dim: int = 64,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
    conv_state: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, tuple]:
    """The chunked SSD form over ``u``, the sequence padded to a multiple
    of ``chunk``.  Returns ``(y (b, s, d_model), (h_last, conv_state))``.
    On a mesh the conv, the SSD chunks and the gated norm run on each
    rank's batch slice (``batch_local``), the two projections as the
    tensors are laid out."""
    fn = functools.partial(_mamba2_scan, ssm_state=ssm_state, head_dim=head_dim, chunk=chunk)
    y, state = batch_local(fn, _core_params(p), u @ p["w_in"], init_state, conv_state)
    return y @ p["w_out"], state


def _core_params(p: Params) -> Params:
    """The small parameters the recurrence itself reads, given whole to
    every rank."""
    return {k: p[k] for k in ("conv", "A_log", "D", "dt_bias", "norm_scale")}


def _mamba2_scan(p: Params, proj: torch.Tensor, init_state, conv_state, *, ssm_state: int,
                 head_dim: int, chunk: int):
    """The recurrence over the input projection ``proj = u @ w_in``:
    ``(y (b, s, d_inner) before w_out, (h_last, conv_state))``."""
    b, s, _ = proj.shape
    d_inner = p["conv"].shape[1]
    heads = d_inner // head_dim
    N = ssm_state

    x, z, B, C, dt = _split_proj(proj, d_inner, N, heads)
    x, conv_out_state = _causal_conv(x, p["conv"], conv_state)
    x = F.silu(x)
    B = F.silu(B)   # (b, s, N): shared across heads (Mamba2 multi-value)
    C = F.silu(C)
    dt = _softplus_dt(dt, p)                                     # (b, s, H) f32
    A = -torch.exp(p["A_log"])                                   # (H,) negative

    xh = x.reshape(b, s, heads, head_dim)
    pad = (-s) % chunk
    xp, Bp, Cp, dtp = xh, B, C, dt
    if pad:
        xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bp = F.pad(B, (0, 0, 0, pad))
        Cp = F.pad(C, (0, 0, 0, pad))
        dtp = F.pad(dt, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xc = xp.reshape(b, nc, chunk, heads, head_dim)
    Bc = Bp.reshape(b, nc, chunk, N)
    Cc = Cp.reshape(b, nc, chunk, N)
    dtc = dtp.reshape(b, nc, chunk, heads)

    # per-step decay a_t = exp(dt_t * A), its cumulative log within a chunk
    cum = torch.cumsum(dtc * A, dim=2)                           # (b, nc, chunk, H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=proj.device).tril()
    causal = causal[None, :, :, None]

    h = (torch.zeros((b, heads, head_dim, N), dtype=torch.float32, device=proj.device)
         if init_state is None else init_state)
    ys = []
    for c in range(nc):
        xck, Bck, Cck, dtk, cumk = xc[:, c].float(), Bc[:, c], Cc[:, c], dtc[:, c], cum[:, c]
        # intra-chunk: L[t, t'] = exp(cum_t - cum_t') for t >= t', masked before the exp
        rel = cumk[:, :, None, :] - cumk[:, None, :, :]          # (b, t, t', H)
        L = torch.exp(torch.where(causal, rel, -1e30))
        cb = torch.einsum("btn,bun->btu", Cck, Bck)              # (b, t, t')
        w = L * cb[..., None] * dtk[:, None, :, :]               # dt at source t'
        y_intra = torch.einsum("btuh,buhp->bthp", w, xck)
        # the carried state's contribution: C_t · (decay_t · h)
        y_state = torch.einsum("btn,bhpn->bthp", Cck.float(), h) * torch.exp(cumk)[..., None]
        # h' = decay_chunk · h + Σ_t decay_{end..t} dt_t B_t x_t
        total = torch.exp(cumk[:, -1])                           # (b, H)
        tail = torch.exp(cumk[:, -1][:, None, :] - cumk)         # (b, t, H)
        dBx = torch.einsum("bth,btn,bthp->bhpn", dtk * tail, Bck.float(), xck)
        h = h * total[:, :, None, None] + dBx
        ys.append((y_intra + y_state).to(proj.dtype))
    y = torch.cat(ys, dim=1)[:, :s]                              # (b, s, H, hd)
    y = y + xh * p["D"][None, None, :, None].to(proj.dtype)
    return _gated_rmsnorm(p, y.reshape(b, s, d_inner), z, proj.dtype), (h, conv_out_state)


def mamba2_decode_step(
    p: Params,
    u: torch.Tensor,              # (b, 1, d_model)
    state: torch.Tensor,          # (b, H, head_dim, N) f32
    conv_state: torch.Tensor,     # (b, CONV_W-1, d_inner)
    *,
    ssm_state: int,
    head_dim: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The O(1) recurrence step.  Returns ``(y (b, 1, d), new_state,
    new_conv_state)``; on a mesh the recurrence on each rank's batch
    slice, the projections as the tensors are laid out."""
    fn = functools.partial(_mamba2_decode_step, ssm_state=ssm_state, head_dim=head_dim)
    y, state, conv_state = batch_local(fn, _core_params(p), u @ p["w_in"], state, conv_state)
    return y @ p["w_out"], state, conv_state


def _mamba2_decode_step(p: Params, proj, state, conv_state, *, ssm_state: int, head_dim: int):
    b = proj.shape[0]
    d_inner = p["conv"].shape[1]
    heads = d_inner // head_dim

    x, z, B, C, dt = _split_proj(proj, d_inner, ssm_state, heads)
    x, conv_state = _causal_conv(x, p["conv"], conv_state)
    x = F.silu(x)[:, 0]                                          # (b, d_inner)
    B = F.silu(B)[:, 0]                                          # (b, N)
    C = F.silu(C)[:, 0]
    dt = _softplus_dt(dt[:, 0], p)                               # (b, H)
    A = -torch.exp(p["A_log"])

    xh = x.reshape(b, heads, head_dim).float()
    decay = torch.exp(dt * A)                                    # (b, H)
    state = state * decay[:, :, None, None] + torch.einsum("bh,bn,bhp->bhpn", dt, B.float(), xh)
    y = torch.einsum("bn,bhpn->bhp", C.float(), state)                   # (b, H, p)
    y = y + xh * p["D"][None, :, None]
    y = _gated_rmsnorm(p, y.reshape(b, 1, d_inner).to(proj.dtype), z, proj.dtype)
    return y, state, conv_state
