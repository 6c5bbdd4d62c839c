"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48L, d_model=1536, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 3072, head_dim 64 -> 48 SSD heads.
"""

from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=48,          # SSD heads (d_inner / head_dim)
    num_kv_heads=48,
    head_dim=64,
    d_ff=0,                # attention-free, no MLP block
    vocab_size=50280,
    norm="rmsnorm",
    rope_kind="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=128),
    sub_quadratic=True,
    notes="Pure Mamba-2: each layer is norm -> SSD mixer -> residual. "
          "long_500k eligible (O(1) decode state).",
)
