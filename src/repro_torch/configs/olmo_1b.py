"""olmo-1b — non-parametric LayerNorm [arXiv:2402.00838]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric",
    norm_eps=1e-5,
    mlp_kind="swiglu",
    rope_theta=10_000.0,
)
