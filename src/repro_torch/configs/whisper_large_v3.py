"""whisper-large-v3 — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

The conv1d+mel frontend is a STUB: the encoder takes precomputed frame
embeddings (B, 1500, d_model).  No positional signal is added on either
side: ``rope_kind="none"``, the attention blocks rotate nothing, and the
embeddings go in as given (the JAX package's model adds no sinusoid
either, although its config's docstring says "sinusoidal on both
sides"; HF's decoder uses learned positions).  The port does what that
code does.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,         # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    qkv_bias=True,
    rope_kind="none",
    mlp_kind="mlp",
    activation="gelu",
    norm="layernorm",
    norm_eps=1e-5,
)
