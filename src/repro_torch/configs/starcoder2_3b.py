"""starcoder2-3b — GQA kv=2, RoPE [arXiv:2402.19173]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_kind="mlp",
    activation="gelu_tanh",
    norm="layernorm",
    norm_eps=1e-5,
    notes="HF uses sliding_window=4096; at the assigned shapes "
          "(train seq 4096) the window covers the sequence, modeled as full "
          "attention (DESIGN.md §4).",
)
