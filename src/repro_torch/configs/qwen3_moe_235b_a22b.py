"""qwen3-moe-235b-a22b [moe]: 94L d4096 64H (GQA kv=4) expert-ff1536
vocab 151936, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B scaled].  qk-norm,
SwiGLU experts, no shared expert."""
from ..models.model import ModelConfig
from ..models.moe import MoECfg

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, act="swiglu", qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoECfg(n_experts=128, top_k=8, d_expert=1536, n_shared=0),
)
