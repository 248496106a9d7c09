"""deepseek-v3-671b [moe]: 61L d7168 128H MLA, 1 shared + 256 routed top-8
experts (ff2048), vocab 129280 [arXiv:2412.19437].  First 3 layers dense
(ff 18432); aux-loss-free router bias; MTP head omitted (documented)."""
from ..models.model import ModelConfig, MLACfg
from ..models.moe import MoECfg

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=2048, vocab=129280, act="swiglu", rope_theta=10_000.0,
    moe=MoECfg(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
               router_scale_bias=True),
    dense_layers=3, dense_d_ff=18432,
    mla=MLACfg(q_lora=1536, kv_lora=512, nope_dim=128, rope_dim=64, v_dim=128),
)
