"""command-r-plus-104b [dense]: 64L d12288 96H (GQA kv=8) ff33792 vocab 256000.
GQA, no-bias, SwiGLU [hf:CohereForAI/c4ai-command-r-v01]."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000, act="swiglu", rope_theta=75_000_000.0,
)
