"""seamless-m4t-medium [audio]: enc-dec, 12+12L d1024 16H ff4096
vocab 256206 [arXiv:2308.11596].  The speech frontend is a stub: the
encoder reads 1024 precomputed frame embeddings a request (``ctx``); the
backbone is the text decoder cross-attending the speech encoder (RMSNorm
+ ReLU FFN)."""
from ..models.model import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab=256206, act="relu", rope_theta=10_000.0,
    enc_dec=True, enc_layers=12, n_ctx_tokens=1024,
)
