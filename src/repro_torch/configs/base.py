"""Shape cells shared by all LM architectures (assigned-architecture pool).

A field-for-field copy of the reference's ``configs/base.py``:

* ``train_4k``    — training step, seq 4096, global batch 256.
* ``prefill_32k`` — inference prefill, seq 32768, global batch 32.
* ``decode_32k``  — one-token decode with a 32K cache, global batch 128.
* ``long_500k``   — one-token decode with a 524288 context, batch 1;
                    only for sub-quadratic archs (SSM / hybrid) — full
                    attention archs skip it.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ShapeCell", "SHAPES", "supports"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq: int
    batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}


def supports(cfg, shape_name: str) -> tuple:
    """Whether an arch runs a shape cell (False -> documented skip)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full-attention arch: 500K dense-KV decode has no "
                       "sub-quadratic path")
    return True, ""
