"""Config schema for the model zoo + the assigned input-shape grid.

The port's own copy of the JAX package's ``configs/base.py`` (plain
dataclasses, no JAX), so that the port imports nothing of that package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["MoEConfig", "MLAConfig", "SSMConfig", "RGLRUConfig",
           "ModelConfig", "ShapeConfig", "SHAPES", "reduced_config"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    shared_experts: int = 0
    first_dense_layers: int = 1
    routing: str = "fish"          # fg | pkg | fish  (paper-scheme analogs)
    capacity_factor: float = 1.25
    tokens_per_group: int = 2048   # dispatch group size (GShard-style)
    fish_alpha: float = 0.2        # inter-epoch decay (paper §6.3)
    fish_theta_frac: float = 0.25  # θ = frac / num_experts
    router_aux_weight: float = 1e-2
    dispatch_impl: str = "einsum"  # einsum | scatter (§Perf lever)
    hot_headroom: float = 2.0      # C_max multiplier over the uniform slice


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0             # 0 -> d_model
    conv_width: int = 4
    attention_every: int = 3       # 1 attn per 3 blocks (rec, rec, attn)
    local_window: int = 2048
    gate_blocks: int = 16          # block-diagonal i/r gate heads


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- attention / pos ---
    qkv_bias: bool = False
    rope_kind: str = "rope"        # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None
    local_global_pattern: Optional[Tuple[str, ...]] = None  # e.g. ("local","global")
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)
    # --- mlp / norm ---
    mlp_kind: str = "swiglu"       # swiglu | geglu | mlp
    activation: str = "silu"
    norm: str = "rmsnorm"          # rmsnorm | rmsnorm_plus_one | layernorm | nonparametric
    norm_eps: float = 1e-6
    post_norms: bool = False       # gemma2 pre+post sandwich norms
    scale_embeddings: bool = False # gemma: embed * sqrt(d_model)
    tie_embeddings: bool = False
    # --- variants ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder_layers: int = 0        # whisper enc-dec
    encoder_seq: int = 1500
    embeds_input: bool = False     # frontend stub feeds embeddings directly
    # --- training / distribution ---
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    opt_factored: bool = False     # Adafactor-style factored second moment
    grad_accum: int = 1            # microbatches per optimizer step
    zero_sharding: bool = True     # shard non-TP weight dim over (pod, data)
    remat: bool = True
    sub_quadratic: bool = False    # eligible for long_500k
    cost_exact: bool = False       # dry-run costing mode: unroll every scan so
                                   # HloCostAnalysis counts all iterations
    notes: str = ""

    @property
    def attention_free(self) -> bool:
        return self.ssm is not None

    def supports_shape(self, shape: "ShapeConfig") -> bool:
        if shape.name == "long_500k":
            return self.sub_quadratic
        return True


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (one fwd/train step)."""
    small_heads = min(cfg.num_heads, 4)
    small_kv = max(1, min(cfg.num_kv_heads, small_heads))
    while small_heads % small_kv:
        small_kv -= 1
    updates = dict(
        num_layers=min(cfg.num_layers, 2),
        d_model=128,
        num_heads=small_heads,
        num_kv_heads=small_kv,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        sliding_window=64 if cfg.sliding_window else None,
        encoder_seq=32 if cfg.encoder_layers else cfg.encoder_seq,
        encoder_layers=min(cfg.encoder_layers, 2),
        zero_sharding=False,
    )
    if cfg.moe:
        updates["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=2, d_ff_expert=64,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            tokens_per_group=64,
        )
    if cfg.mla:
        updates["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_dim=32,
                                   qk_rope_dim=16, v_head_dim=32)
        updates["head_dim"] = 32
    if cfg.ssm:
        updates["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                             chunk=16)
    if cfg.rglru:
        updates["rglru"] = dataclasses.replace(cfg.rglru, lru_width=128,
                                               local_window=32)
    if cfg.local_global_pattern:
        updates["sliding_window"] = 32
    return dataclasses.replace(cfg, **updates)
