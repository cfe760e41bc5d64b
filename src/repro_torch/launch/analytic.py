"""Analytic FLOP / HBM-byte accounting per (arch × shape).

The port of ``repro.launch.analytic``, line for line over the port's
``ModelConfig``: the same floats, bit for bit, for every arch and shape,
its quirks kept (the unused ``period`` in ``_attn_layer_count``).  The
reference's reason for it follows.

``cost_analysis()`` on scan-based HLO counts each loop body ONCE (XLA
cost analysis does not multiply by trip count), so compiled-artifact FLOPs
under-count deep models by ~L×.  The roofline therefore uses these exact
analytic formulas for the compute and memory terms — standard 6ND-style
accounting extended with attention, MoE routing and cache traffic — and
keeps the raw artifact numbers alongside for transparency
(EXPERIMENTS.md §Roofline documents the discrepancy).

Conventions:
  * bf16 params/activations (2 B), f32 optimizer moments (4 B);
  * train FLOPs = 3× forward (fwd + 2× bwd), remat adds +1× forward of
    recomputation inside the bwd when enabled (factor 4 instead of 3);
  * causal attention counts the full s² score work for the chunked
    implementation (it does not skip fully-masked blocks — recorded as a
    known optimization target in §Perf).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class CellCost:
    flops: float
    hbm_bytes: float
    notes: str = ""


def _attn_flops_fwd(cfg: ModelConfig, b: int, s: int, causal_skip: bool) -> float:
    """QKVO projections + score/value matmuls for one forward pass, all layers."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.kv_heads
    L = _attn_layer_count(cfg)
    proj = 2 * b * s * d * (H * hd + 2 * KV * hd + H * hd)
    pair_factor = 0.5 if causal_skip else 1.0
    scores = 2 * b * H * s * s * hd * pair_factor * 2  # qk^T and attn@v
    return L * (proj + scores)


def _attn_layer_count(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_period  # shared block applications
    if cfg.family == "vlm":
        period = cfg.cross_attn_period
        return cfg.num_layers  # self layers + cross layers ≈ num_layers total
    if cfg.family == "ssm":
        return 0
    return cfg.num_layers


def _ffn_flops_fwd(cfg: ModelConfig, tokens: float) -> float:
    mats = 3 if cfg.act in ("swiglu", "geglu") else 2
    if cfg.moe:
        per_tok = 2 * mats * cfg.d_model * cfg.d_ff * cfg.moe.top_k
        router = 2 * cfg.d_model * cfg.moe.num_experts
        n_ffn = cfg.num_layers
        return tokens * n_ffn * (per_tok + router)
    if cfg.d_ff == 0 or cfg.family == "hybrid":
        return 0.0
    n_ffn = cfg.num_layers if cfg.family != "vlm" else cfg.num_layers
    return tokens * n_ffn * 2 * mats * cfg.d_model * cfg.d_ff


def _recurrent_flops_fwd(cfg: ModelConfig, b: int, s: int) -> float:
    d = cfg.d_model
    if cfg.family == "ssm":
        # mLSTM/sLSTM: 4 d×d projections + per-step d_head² memory update
        hd = d // cfg.num_heads
        per_tok = 2 * 4 * d * d + 2 * cfg.num_heads * hd * hd * 2
        return cfg.num_layers * b * s * per_tok
    if cfg.family == "hybrid":
        d_inner = 2 * d
        N = cfg.ssm_state
        heads = d_inner // 64
        per_tok = (
            2 * d * (2 * d_inner + 2 * N + heads)   # in-proj
            + 2 * d_inner * d                        # out-proj
            + 2 * heads * 64 * N * 2                 # state update + readout
        )
        return cfg.num_layers * b * s * per_tok
    return 0.0


def _embed_head_flops_fwd(cfg: ModelConfig, tokens: float) -> float:
    heads = cfg.num_codebooks or 1
    return 2 * tokens * cfg.d_model * cfg.padded_vocab * heads


def forward_flops(cfg: ModelConfig, b: int, s: int, *, causal_skip: bool = False) -> float:
    tokens = float(b) * s
    return (
        _attn_flops_fwd(cfg, b, s, causal_skip)
        + _ffn_flops_fwd(cfg, tokens)
        + _recurrent_flops_fwd(cfg, b, s)
        + _embed_head_flops_fwd(cfg, tokens)
    )


def _param_bytes(cfg: ModelConfig) -> float:
    return cfg.param_count() * 2.0  # bf16


def _act_traffic_fwd(cfg: ModelConfig, b: int, s: int) -> float:
    """HBM activation traffic of one forward pass (reads+writes), bf16."""
    d = cfg.d_model
    per_tok_per_layer = (
        4 * d            # residual stream reads/writes
        + 4 * d          # attn/block in+out
        + (6 * cfg.d_ff * (cfg.moe.top_k / 1 if cfg.moe else 1) if cfg.d_ff else 8 * d)
    )
    return 2.0 * b * s * cfg.num_layers * per_tok_per_layer


def train_cost(cfg: ModelConfig, shape: ShapeConfig, *, remat: bool = True,
               optimizer: str = "adamw") -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    fwd = forward_flops(cfg, b, s)
    flops = fwd * (4.0 if remat else 3.0)
    opt_bytes_per_param = 24.0 if optimizer == "adamw" else 8.5
    p = cfg.param_count()
    hbm = (
        p * (2 + 2 + 2)                    # params read (fwd+bwd) + grads write
        + p * opt_bytes_per_param          # optimizer read/write
        + _act_traffic_fwd(cfg, b, s) * (3.0 if remat else 2.0)
    )
    return CellCost(flops=flops, hbm_bytes=hbm,
                    notes=f"remat={remat} optimizer={optimizer}")


def prefill_cost(cfg: ModelConfig, shape: ShapeConfig) -> CellCost:
    b, s = shape.global_batch, shape.seq_len
    return CellCost(
        flops=forward_flops(cfg, b, s),
        hbm_bytes=_param_bytes(cfg) + _act_traffic_fwd(cfg, b, s)
        + 2.0 * b * s * _attn_layer_count(cfg) * cfg.kv_heads
        * cfg.resolved_head_dim * 2 * 2,  # KV cache write
        notes="prefill",
    )


def decode_cost(cfg: ModelConfig, shape: ShapeConfig, *, window: int | None = None,
                kv_dtype_bytes: float = 2.0) -> CellCost:
    """kv_dtype_bytes: 2.0 bf16, 1.125 for int8 + per-head scales."""
    b, S = shape.global_batch, shape.seq_len
    ctx = min(S, window) if window else S
    flops = forward_flops(cfg, b, 1)
    # attention over the cache: 2 matmuls of (1 × ctx × hd) per head
    L_attn = _attn_layer_count(cfg)
    flops += L_attn * 2 * b * cfg.num_heads * ctx * cfg.resolved_head_dim * 2
    kv_bytes = L_attn * b * ctx * cfg.kv_heads * cfg.resolved_head_dim * 2 * kv_dtype_bytes
    state_bytes = 0.0
    if cfg.family in ("ssm", "hybrid"):
        d_inner = 2 * cfg.d_model
        if cfg.family == "ssm":
            hd = cfg.d_model // cfg.num_heads
            state_bytes = cfg.num_layers * b * cfg.num_heads * hd * hd * 4 * 2
        else:
            heads = d_inner // 64
            state_bytes = cfg.num_layers * b * heads * 64 * cfg.ssm_state * 4 * 2
    hbm = _param_bytes(cfg) + kv_bytes + state_bytes
    return CellCost(flops=flops, hbm_bytes=hbm, notes=f"decode ctx={ctx}")


def cell_cost(cfg: ModelConfig, shape: ShapeConfig, **kw) -> CellCost:
    if shape.kind == "train":
        return train_cost(cfg, shape, **kw)
    if shape.kind == "prefill":
        return prefill_cost(cfg, shape)
    return decode_cost(cfg, shape, **kw)
