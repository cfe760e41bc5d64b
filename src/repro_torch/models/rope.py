"""Rotary position embeddings: standard (Llama) and 2D/partial (ChatGLM).

The port of ``repro.models.rope``.  ``partial=True`` (ChatGLM3's
``rope_2d``) rotates only the first half of each head's dims, in
interleaved pairs ``(x[2i], x[2i+1])``, and leaves the rest as it is.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharding import replicate_like


def rope_frequencies(head_dim: int, theta: float, rot_dim: int | None = None,
                     device="cpu") -> torch.Tensor:
    rot = rot_dim or head_dim
    exponent = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exponent)  # (rot/2,)


def apply_rope(
    x: torch.Tensor,           # (..., seq, heads, head_dim)
    positions: torch.Tensor,   # (..., seq)
    *,
    theta: float = 10_000.0,
    partial: bool = False,     # rotate only first half of head_dim (GLM)
) -> torch.Tensor:
    head_dim = x.shape[-1]
    rot_dim = head_dim // 2 if partial else head_dim
    inv = replicate_like(rope_frequencies(head_dim, theta, rot_dim, device=x.device), x)
    ang = positions[..., None].float() * inv          # (..., seq, rot/2)
    cos = torch.cos(ang)[..., None, :]                # broadcast over heads
    sin = torch.sin(ang)[..., None, :]

    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    if partial:
        return torch.cat([rotated, x[..., rot_dim:]], dim=-1)
    return rotated
