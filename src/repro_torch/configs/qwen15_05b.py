"""qwen1.5-0.5b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    norm="rmsnorm",
    notes="HF ties embeddings; kept untied here (noted param-count delta "
          "+155M).",
)
