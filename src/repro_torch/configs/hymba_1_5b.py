"""hymba-1.5b [hybrid]: 32L d1600 25H (GQA kv=5) ff5504 vocab 32001, ssm_state=16.
Parallel attention + Mamba heads per layer [arXiv:2411.13676]; sliding-window
attention everywhere except 3 full-attention layers (first/middle/last).
25 heads are not TP-divisible -> TP shards head_dim (tp_heads=False)."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, act="swiglu", rope_theta=10_000.0,
    tp_heads=False,
    ssm_state=16, ssm_conv=4, ssm_expand=2, hybrid=True,
    full_attn_layers=(0, 15, 31), sliding_window=2048,
)
