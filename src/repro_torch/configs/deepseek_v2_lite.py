"""deepseek-v2-lite-16b — MLA (kv_lora=512) + MoE 64e top-6, 2 shared
[arXiv:2405.04434].
"""

from .base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,       # MLA is effectively MHA over the latent
    head_dim=128,          # v head dim (see MLAConfig for q/k dims)
    d_ff=10944,            # dense first layer
    vocab_size=102_400,
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        shared_experts=2,
        first_dense_layers=1,
        routing="fish",
        capacity_factor=1.25,
        tokens_per_group=1024,
        fish_alpha=0.2,
        dispatch_impl="scatter",   # §Perf: -10..-21% HLO FLOPs vs one-hot
        hot_headroom=1.25,         # §Perf: no empty-slot expert compute
    ),
    notes="Assignment table lists '64e top-6' and '2 shared+160 routed'; "
          "the HF config has 64 routed experts (160 is V2-full) — using 64 "
          "routed + 2 shared, top-6.",
)
