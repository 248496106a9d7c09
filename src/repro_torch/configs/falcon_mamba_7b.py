"""falcon-mamba-7b [ssm]: 64L d4096, attention-free Mamba-1, ssm_state=16,
vocab 65024 [arXiv:2410.05355].  Pure mamba mixer blocks (d_ff=0); O(1)
decode state -> runs the long_500k cell."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, head_dim=64,
    d_ff=0, vocab=65024, act="silu", rope_theta=0.0,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)
