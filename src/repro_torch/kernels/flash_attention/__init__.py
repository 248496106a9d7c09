"""Flash attention (GQA; causal with a sliding window, or not causal):
the CUDA forward kernel, its plain version, the op that picks one by
device, and the op's gradient (``backward.py``, PyTorch operations)."""
from .backward import attention_backward
from .ops import FlashAttentionFn, flash_attention_op
from .ref import BLOCK_K, NEG, flash_attention_ref, live_pairs

__all__ = ["flash_attention_op", "FlashAttentionFn", "attention_backward",
           "flash_attention_ref", "live_pairs", "NEG", "BLOCK_K"]
