"""Optimizer: AdamW with global-norm clipping and schedules
(:mod:`.adamw`), and error-feedback int8 gradient compression
(:mod:`.compression`)."""
from .adamw import (AdamWConfig, adamw_update, global_norm, init_opt,
                    opt_specs, warmup_cosine)
from .compression import (compress, compress_tree, compressed_psum,
                          decompress, decompress_tree)

__all__ = ["AdamWConfig", "adamw_update", "global_norm", "init_opt",
           "opt_specs", "warmup_cosine", "compress", "compress_tree",
           "compressed_psum", "decompress", "decompress_tree"]
