"""qwen3-1.7b [dense]: 28L d2048 16H (GQA kv=8) ff6144 vocab 151936.
qk-norm + GQA + SwiGLU [hf:Qwen/Qwen3-8B]."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab=151936, act="swiglu", qk_norm=True, rope_theta=1_000_000.0,
)
