"""qwen2-vl-2b — M-RoPE, dynamic resolution [arXiv:2409.12191].

VLM entry: the ViT frontend is a STUB — a batch carries precomputed patch
and token embeddings ``embeds`` (B, S, d_model) plus the (3, B, S) M-RoPE
position streams ``positions`` (temporal, height, width).  Only the
transformer backbone is modeled.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    qkv_bias=True,
    rope_kind="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    mlp_kind="swiglu",
    norm="rmsnorm",
    embeds_input=True,
)
