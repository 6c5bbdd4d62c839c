"""gemma2-2b — local+global alternating attention, logit softcap
[arXiv:2408.00118]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256_000,
    mlp_kind="geglu",
    norm="rmsnorm_plus_one",
    post_norms=True,
    scale_embeddings=True,
    tie_embeddings=True,
    attn_softcap=50.0,
    logit_softcap=30.0,
    sliding_window=4096,
    local_global_pattern=("local", "global"),
    rope_theta=10_000.0,
)
