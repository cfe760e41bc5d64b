"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM.

The port of ``repro.models.xlstm``.  mLSTM keeps a per-head matrix
memory ``C ∈ R^{hd×hd}`` with an exponential input gate and a sigmoid
forget gate, stabilized by the running max ``m`` (log-space gating);
sLSTM is a scalar-memory LSTM with exponential gating and per-head
recurrent weights.  JAX's ``lax.scan`` over time (and, in
:func:`mlstm_chunked`, over chunks) is a Python loop over the steps;
every carried state is float32, as in the reference, and the one-token
decode steps are the scans at ``s = 1`` from a given state.

The stabilizers start where the reference's do: ``m0 = -1e30`` for
mLSTM, ``n0 = 1`` and ``m0 = 0`` for sLSTM, whose normalizer is
``max(n, 1e-6)``.  Every mask is applied to a log-space value before its
``exp`` (the chunked form's causal mask, the padded steps' ``log_i =
-1e30`` and ``log_f = 0``), so no ``inf · 0`` reaches a gradient.

On a device mesh each scan runs whole, its projections included, on each
rank's batch slice (``dist.sharding.batch_local``: the parameters given
whole to every rank).  Its projections do not run tensor-parallel, as
Mamba2's do: the mLSTM's normalizer divides by ``max(|q·n|, e^{-m})``,
which turned a TP split's other summation order into errors of 2-6e-5 on
the smoke config's logits (held to 1e-5 against one device), and the
family's weights are small (xlstm-125m's, 0.2 GB).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import batch_local
from repro_torch.models.layers import Params, _trunc_normal, dense_init, on_device


# ------------------------------------------------------------- mLSTM ----

def init_mlstm(generator: torch.Generator, d_model: int, num_heads: int, dtype, *,
               device=None) -> Params:
    device = on_device(generator, device)
    return {
        "wq": dense_init(generator, d_model, d_model, dtype, device=device),
        "wk": dense_init(generator, d_model, d_model, dtype, device=device),
        "wv": dense_init(generator, d_model, d_model, dtype, device=device),
        "wo": dense_init(generator, d_model, d_model, dtype, scale=0.5, device=device),
        # input & forget gate projections (scalar per head, f32 for stability)
        "wif": dense_init(generator, d_model, 2 * num_heads, torch.float32, device=device),
        "b_i": torch.zeros((num_heads,), dtype=torch.float32, device=device),
        "b_f": torch.full((num_heads,), 3.0, dtype=torch.float32, device=device),
    }


def _mlstm_gates(p: Params, x: torch.Tensor, num_heads: int):
    """``(log_i, log_f)``, each ``(b, s, H)`` float32: the input gate's
    pre-activation and the forget gate's log-sigmoid."""
    b, s, _ = x.shape
    gates = (x.float() @ p["wif"]).reshape(b, s, 2, num_heads)
    return gates[:, :, 0] + p["b_i"], F.logsigmoid(gates[:, :, 1] + p["b_f"])


def mlstm_scan(
    p: Params,
    x: torch.Tensor,          # (b, s, d_model)
    num_heads: int,
    *,
    init_state: tuple | None = None,
) -> Tuple[torch.Tensor, tuple]:
    """The sequential mLSTM.  Returns ``(y (b, s, d), (C, n, m))``, the
    final state float32 ``(b, H, hd, hd)``, ``(b, H, hd)``, ``(b, H)``.
    On a mesh it runs on each rank's batch slice (``batch_local``, see the
    module docstring)."""
    return batch_local(functools.partial(_mlstm_scan, num_heads=num_heads), p, x, init_state)


def _mlstm_scan(p: Params, x: torch.Tensor, init_state, *, num_heads: int):
    b, s, d = x.shape
    hd = d // num_heads
    scale = 1.0 / math.sqrt(hd)

    q = (x @ p["wq"]).reshape(b, s, num_heads, hd).float()
    k = ((x @ p["wk"]).reshape(b, s, num_heads, hd) * scale).float()
    v = (x @ p["wv"]).reshape(b, s, num_heads, hd).float()
    log_i, log_f = _mlstm_gates(p, x, num_heads)

    if init_state is None:
        C = torch.zeros((b, num_heads, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, num_heads, hd), dtype=torch.float32, device=x.device)
        m = torch.full((b, num_heads), -1e30, dtype=torch.float32, device=x.device)
    else:
        C, n, m = init_state

    hs = []
    for t in range(s):
        qt, kt, vt, li, lf = q[:, t], k[:, t], v[:, t], log_i[:, t], log_f[:, t]
        m_new = torch.maximum(lf + m, li)
        f_eff = torch.exp(lf + m - m_new)[..., None]
        i_eff = torch.exp(li - m_new)[..., None]
        C = C * f_eff[..., None] + i_eff[..., None] * (kt[..., :, None] * vt[..., None, :])
        n = n * f_eff + i_eff * kt
        num = torch.einsum("bhd,bhde->bhe", qt, C)
        den = torch.einsum("bhd,bhd->bh", qt, n).abs()
        h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
        m = m_new
        hs.append(h.to(x.dtype))
    y = torch.stack(hs, dim=1).reshape(b, s, d)
    return y @ p["wo"], (C, n, m)


def mlstm_chunked(
    p: Params,
    x: torch.Tensor,          # (b, s, d_model)
    num_heads: int,
    *,
    chunk: int = 256,
) -> Tuple[torch.Tensor, tuple]:
    """Chunkwise-parallel mLSTM (:func:`_mlstm_chunked`); on a mesh on each
    rank's batch slice (``batch_local``)."""
    return batch_local(functools.partial(_mlstm_chunked, num_heads=num_heads, chunk=chunk),
                       p, x)


def _mlstm_chunked(p: Params, x: torch.Tensor, *, num_heads: int,
                   chunk: int) -> Tuple[torch.Tensor, tuple]:
    """Chunkwise-parallel mLSTM, equal to :func:`mlstm_scan` up to the
    order of the float32 sums, with ``ceil(s / chunk)`` sequential steps.

    With ``F_t = Σ log_f`` and ``g_t = log_i_t − F_t`` the stabilizer is
    ``m_t = F_t + G_t``, ``G_t = max g_{≤t}`` (``torch.cummax`` within a
    chunk, JAX's ``lax.cummax``); the carried matrix memory is
    ``C̃ = Σ exp(g − M) k vᵀ`` with ``M`` the carried max.  The sequence
    is padded to a multiple of ``chunk`` with steps that neither forget
    nor write.  Returns ``(y, (C, n, F + M))``, the final state in the
    sequential form's terms.
    """
    b, s, d = x.shape
    hd = d // num_heads
    scale = 1.0 / math.sqrt(hd)
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    sp = s + pad
    nc = sp // chunk

    q = (x @ p["wq"]).reshape(b, sp, num_heads, hd).float()
    k = (x @ p["wk"]).reshape(b, sp, num_heads, hd).float() * scale
    v = (x @ p["wv"]).reshape(b, sp, num_heads, hd).float()
    log_i, log_f = _mlstm_gates(p, x, num_heads)
    if pad:
        # padded steps: forget gate 1 (log 0), input gate exp(-1e30) = 0
        padmask = (torch.arange(sp, device=x.device) >= s)[None, :, None]
        log_i = torch.where(padmask, -1e30, log_i)
        log_f = torch.where(padmask, 0.0, log_f)

    C = torch.zeros((b, num_heads, hd, hd), dtype=torch.float32, device=x.device)
    n = torch.zeros((b, num_heads, hd), dtype=torch.float32, device=x.device)
    M = torch.full((b, num_heads), -1e30, dtype=torch.float32, device=x.device)
    Fc = torch.zeros((b, num_heads), dtype=torch.float32, device=x.device)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    hs = []
    for c in range(nc):
        blk = slice(c * chunk, (c + 1) * chunk)
        q_blk, k_blk, v_blk, li, lf = q[:, blk], k[:, blk], v[:, blk], log_i[:, blk], log_f[:, blk]
        Floc = torch.cumsum(lf, dim=1)                    # (b, t, H)
        Fg = Fc[:, None, :] + Floc                        # global F at each t
        g = li - Fg                                       # (b, t, H)
        Gloc = torch.cummax(g, dim=1).values
        G = torch.maximum(M[:, None, :], Gloc)            # (b, t, H) running max
        # intra-chunk weights w[t, t'] = exp(g_t' - G_t), masked before the exp
        wlog = g[:, None, :, :] - G[:, :, None, :]        # (b, t, t', H)
        w = torch.exp(torch.where(causal, wlog, -1e30))
        inter = torch.exp(M[:, None, :] - G)              # (b, t, H)
        qk = torch.einsum("bthd,buhd->btuh", q_blk, k_blk)
        scores = w * qk
        num = (torch.einsum("bthd,bhde->bthe", q_blk, C) * inter[..., None]
               + torch.einsum("btuh,buhe->bthe", scores, v_blk))
        den_vec = torch.einsum("bthd,bhd->bth", q_blk, n) * inter + scores.sum(dim=2)
        m_t = Fg + G
        hs.append(num / torch.maximum(den_vec.abs(), torch.exp(-m_t))[..., None])
        # end-of-chunk state update
        M_new = G[:, -1]                                  # (b, H)
        decay = torch.exp(M - M_new)
        wk = torch.exp(g - M_new[:, None, :])             # (b, t, H)
        C = C * decay[..., None, None] + torch.einsum("bth,bthd,bthe->bhde", wk, k_blk, v_blk)
        n = n * decay[..., None] + torch.einsum("bth,bthd->bhd", wk, k_blk)
        Fc = Fc + Floc[:, -1]
        M = M_new
    y = torch.cat(hs, dim=1).reshape(b, sp, d)[:, :s].to(x.dtype)
    return y @ p["wo"], (C, n, Fc + M)


def mlstm_decode_step(p: Params, x: torch.Tensor, state: tuple, num_heads: int):
    """One-token step.  x: ``(b, 1, d)``.  Returns ``(y (b, 1, d), new_state)``."""
    return mlstm_scan(p, x, num_heads, init_state=state)


# ------------------------------------------------------------- sLSTM ----

def init_slstm(generator: torch.Generator, d_model: int, num_heads: int, dtype, *,
               device=None) -> Params:
    hd = d_model // num_heads
    device = on_device(generator, device)
    return {
        # input projections for [z, i, f, o]
        "w_in": dense_init(generator, d_model, 4 * d_model, dtype, device=device),
        # block-diagonal recurrent weights per head: (H, hd, 4*hd)
        "w_rec": _trunc_normal(generator, (num_heads, hd, 4 * hd), 1.0 / math.sqrt(hd),
                               torch.float32, device),
        "bias": torch.cat([
            torch.zeros((2 * d_model,), dtype=torch.float32, device=device),
            torch.full((d_model,), 3.0, dtype=torch.float32, device=device),  # forget bias
            torch.zeros((d_model,), dtype=torch.float32, device=device),
        ]),
        "wo": dense_init(generator, d_model, d_model, dtype, scale=0.5, device=device),
    }


def slstm_scan(
    p: Params,
    x: torch.Tensor,
    num_heads: int,
    *,
    init_state: tuple | None = None,
) -> Tuple[torch.Tensor, tuple]:
    """The sequential sLSTM.  Returns ``(y (b, s, d), (c, n, h, m))``, each
    state float32 ``(b, d)``.  On a mesh it runs on each rank's batch
    slice (``batch_local``)."""
    return batch_local(functools.partial(_slstm_scan, num_heads=num_heads), p, x, init_state)


def _slstm_scan(p: Params, x: torch.Tensor, init_state, *, num_heads: int):
    b, s, d = x.shape
    hd = d // num_heads
    xin = (x @ p["w_in"]).float()  # (b, s, 4d)

    if init_state is None:
        c = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        n = torch.ones((b, d), dtype=torch.float32, device=x.device)
        h = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        m = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    else:
        c, n, h, m = init_state

    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(b, num_heads, hd),
                           p["w_rec"]).reshape(b, 4 * d)
        za, ia, fa, oa = torch.split(xin[:, t] + rec + p["bias"], d, dim=-1)
        z = torch.tanh(za)
        o = torch.sigmoid(oa)
        lf = F.logsigmoid(fa)
        m_new = torch.maximum(lf + m, ia)
        i_eff = torch.exp(ia - m_new)
        f_eff = torch.exp(lf + m - m_new)
        c = f_eff * c + i_eff * z
        n = f_eff * n + i_eff
        h = o * (c / torch.maximum(n, n.new_tensor(1e-6)))
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    return y @ p["wo"], (c, n, h, m)


def slstm_decode_step(p: Params, x: torch.Tensor, state: tuple, num_heads: int):
    """One-token step.  x: ``(b, 1, d)``.  Returns ``(y (b, 1, d), new_state)``."""
    return slstm_scan(p, x, num_heads, init_state=state)
