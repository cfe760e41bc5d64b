"""Config schema of the port: one dataclass describes every LM architecture.

A copy of ``repro.configs.base`` (``MoEConfig``, ``ModelConfig``,
``ShapeConfig``, ``SHAPES`` and the registry) with ``jnp_dtype`` replaced
by :attr:`ModelConfig.torch_dtype`.  Each ported
``src/repro_torch/configs/<arch>.py`` exports ``FULL`` (the published
configuration) and ``smoke()`` (a reduced config of the same family).

The registry (:func:`get_config`, :func:`list_configs`) resolves
``--arch`` ids to ``repro_torch.configs.<module>``.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor for dense dispatch (tokens per expert = tokens/E * cf)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description (decoder LM family unless noted)."""

    name: str
    family: str                  # dense | moe | ssm | vlm | hybrid | audio | recsys
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0            # 0 → d_model // num_heads
    moe: Optional[MoEConfig] = None
    ssm_state: int = 0           # Mamba2 state dim (hybrid/ssm)
    rope_theta: float = 10_000.0
    rope_2d: bool = False        # ChatGLM-style: rotary on half the head dims
    use_bias: bool = False
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    act: str = "swiglu"          # swiglu | geglu | gelu
    tie_embeddings: bool = False
    # vlm: cross-attention every `cross_attn_period` layers
    cross_attn_period: int = 0
    num_image_tokens: int = 0    # vlm stub frontend output length
    # audio: number of parallel codebooks (musicgen)
    num_codebooks: int = 0
    # hybrid (zamba): shared attention block applied every `shared_attn_period`
    shared_attn_period: int = 0
    # xlstm: ratio of sLSTM blocks (rest mLSTM)
    slstm_every: int = 0
    # sub-quadratic attention available (gates long_500k)
    subquadratic: bool = False
    # MoE dispatch groups (1 = global cumsum)
    moe_groups: int = 1
    # "gspmd": auto-partitioned dispatch; "shardmap": manual shard-local
    moe_impl: str = "gspmd"
    # training schedule
    schedule: str = "cosine"     # cosine | wsd
    dtype: str = "bfloat16"

    # -- derived -----------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.kv_heads, 1)

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 256 multiple (standard embedding padding;
        the loss and the greedy argmax ignore the padded tail)."""
        return ((self.vocab_size + 255) // 256) * 256

    def param_count(self) -> int:
        """Approximate parameter count (reported, and used for 6ND)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        hd = self.resolved_head_dim
        attn = d * hd * self.num_heads + 2 * d * hd * self.kv_heads + hd * self.num_heads * d
        if self.family == "ssm":
            per_layer = 8 * d * d // 2  # xlstm-ish blocks
        elif self.family == "hybrid":
            dm = 2 * self.d_model
            per_layer = 2 * d * dm + dm * d  # mamba in/out proj (approx)
        else:
            per_layer = attn
        if self.moe:
            ff = 3 * d * self.d_ff * self.moe.num_experts + d * self.moe.num_experts
        elif self.d_ff and self.family != "hybrid":
            ff = 3 * d * self.d_ff
        else:
            ff = 0  # ssm/hybrid blocks carry their own projections (no FFN)
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.num_codebooks:
            emb = self.num_codebooks * V * d + self.num_codebooks * V * d
        return L * (per_layer + ff) + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        full_ff = 3 * d * self.d_ff * self.moe.num_experts
        act_ff = 3 * d * self.d_ff * self.moe.top_k
        return self.param_count() - L * (full_ff - act_ff)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "minicpm-2b",
    "stablelm-3b",
    "chatglm3-6b",
    "command-r-35b",
    "grok-1-314b",
    "granite-moe-3b-a800m",
    "xlstm-125m",
    "llama-3.2-vision-11b",
    "zamba2-7b",
    "musicgen-medium",
]

_MODULE_OF = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}
_MODULE_OF["dlrm-recross"] = "dlrm_recross"


def get_config(arch: str, *, smoke: bool = False):
    """Resolves ``--arch`` ids to (ModelConfig | DLRMConfig)."""
    if arch not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_OF)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch]}")
    return mod.smoke() if smoke else mod.FULL


def list_configs() -> list[str]:
    return list(_MODULE_OF)


def supported_shapes(cfg: ModelConfig) -> list[str]:
    """Shape cells defined for this arch (long_500k only if sub-quadratic)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")
    return out
