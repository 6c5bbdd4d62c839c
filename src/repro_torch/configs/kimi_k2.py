"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2, paper-table spec].

Per the assignment table: GQA kv=8 (not MLA), d_model=7168, 61 layers,
expert d_ff=2048.  1 shared expert + first layer dense (Kimi-K2/DSv3 style).
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,            # the single dense (first) layer
    vocab_size=163_840,
    mlp_kind="swiglu",
    norm="rmsnorm",
    rope_theta=50_000.0,
    moe=MoEConfig(
        num_experts=384,
        top_k=8,
        d_ff_expert=2048,
        shared_experts=1,
        first_dense_layers=1,
        routing="fish",
        capacity_factor=1.25,
        tokens_per_group=512,
        fish_alpha=0.2,
        dispatch_impl="scatter",   # §Perf: -10..-21% HLO FLOPs vs one-hot
        hot_headroom=1.25,         # §Perf: no empty-slot expert compute
    ),
    opt_state_dtype="bfloat16",   # 1T params: fp32 m/v would not fit 16G HBM
    opt_factored=True,            # Adafactor-style v: O(n+m) second moment
    grad_accum=8,                 # microbatching keeps activations in HBM
    zero_sharding=True,
    notes="~1.03T total / ~32B active params. FISH expert routing is the "
          "paper-technique integration point (DESIGN.md §1.2).",
)
