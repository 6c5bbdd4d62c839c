"""recurrentgemma-9b — RG-LRU + local attention, 1 attn per 3 blocks
[arXiv:2402.19427]."""

from .base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,        # MQA in the attention blocks
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    mlp_kind="geglu",
    norm="rmsnorm_plus_one",
    scale_embeddings=True,
    tie_embeddings=True,
    logit_softcap=30.0,
    rope_theta=10_000.0,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4, attention_every=3,
                      local_window=2048, gate_blocks=16),
    sub_quadratic=True,
    notes="(rec, rec, attn) pattern: 38 = 12 groups + 2 trailing rec layers. "
          "Decode attention caches are window-sized ring buffers -> "
          "long_500k eligible.",
)
