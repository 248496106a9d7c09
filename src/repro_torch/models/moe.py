"""The Mixture-of-Experts block's configuration.

A field-for-field copy of the reference's ``MoECfg``
(``repro.models.moe``): the serving bridge reads its ``top_k`` and
``capacity_factor`` to size a request's expert-parallel All2All.  The
MoE block itself is not ported (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import dataclasses

__all__ = ["MoECfg"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_scale_bias: bool = False    # DeepSeek aux-loss-free bias
