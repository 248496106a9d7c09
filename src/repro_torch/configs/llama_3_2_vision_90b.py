"""llama-3.2-vision-90b [vlm]: 100L d8192 64H (GQA kv=8) ff28672 vocab 128256.
20 super-blocks of (4 self-attn + 1 gated cross-attn to vision tokens)
[hf:meta-llama/Llama-3.2-11B-Vision].  The vision frontend is a stub: the
model attends 1600 precomputed patch embeddings a request (``ctx``)."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, act="swiglu", rope_theta=500_000.0,
    cross_every=5, n_ctx_tokens=1600,
)
