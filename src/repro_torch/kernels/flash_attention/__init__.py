"""Flash attention forward (GQA; causal with a sliding window, or not
causal): the CUDA kernel, its plain version, and the op that picks one
by device."""
from .ops import flash_attention_op
from .ref import BLOCK_K, NEG, flash_attention_ref, live_pairs

__all__ = ["flash_attention_op", "flash_attention_ref", "live_pairs", "NEG",
           "BLOCK_K"]
