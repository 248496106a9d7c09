"""starcoder2-15b [dense]: 40L d6144 48H (GQA kv=4) ff24576 vocab 49152.
GQA + RoPE + (non-gated) GELU MLP [arXiv:2402.19173]."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab=49152, act="gelu", rope_theta=100_000.0,
)
