"""Workload-program IR: a declarative multi-phase traffic program.

The port's own copy of the reference's ``repro.workloads.ir``: the same
checks with the same messages.

A :class:`WorkloadProgram` is the intermediate representation every
collective lowers to before execution: ``n_phases`` rows of per-endpoint
``partner`` / ``packets`` arrays.  Phase ``p`` means "endpoint ``e`` sends
``packets[p, e]`` packets to ``partner[p, e]``" — self-partnered endpoints
(``partner[p, e] == e``) model ranks idle in that phase; their packets are
delivered by the same-leaf local fast path and still count toward the
phase's ejection target (the completion semantics the engine measures).

The IR is deliberately execution-agnostic: *when* phase ``p+1`` may start
relative to phase ``p`` is a property of the compiled schedule
(:func:`repro_torch.workloads.compile.compile_program`), not of the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["WorkloadProgram"]


@dataclasses.dataclass(frozen=True)
class WorkloadProgram:
    """``n_phases`` rows of per-endpoint destinations and message sizes.

    * ``partner``  — int32 ``[n_phases, S]``, destination endpoint ids.
    * ``packets``  — int32 ``[n_phases, S]``, per-endpoint message sizes
      (``0`` = endpoint silent in that phase).
    """

    name: str
    partner: np.ndarray
    packets: np.ndarray

    def __post_init__(self):
        partner = np.ascontiguousarray(np.asarray(self.partner, np.int32))
        packets = np.ascontiguousarray(np.asarray(self.packets, np.int32))
        object.__setattr__(self, "partner", partner)
        object.__setattr__(self, "packets", packets)
        self.validate()

    # ------------------------------------------------------------------ #
    @property
    def n_phases(self) -> int:
        return self.partner.shape[0]

    @property
    def n_endpoints(self) -> int:
        return self.partner.shape[1]

    def expected(self) -> np.ndarray:
        """Per-phase ejection target: every packet of the phase delivered
        (network *and* local fast-path deliveries both count)."""
        return self.packets.sum(axis=1, dtype=np.int64)

    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        if self.partner.ndim != 2:
            raise ValueError(f"partner must be [n_phases, S], got shape "
                             f"{self.partner.shape}")
        if self.packets.shape != self.partner.shape:
            raise ValueError(
                f"packets shape {self.packets.shape} != partner shape "
                f"{self.partner.shape}")
        n_phases, S = self.partner.shape
        if n_phases < 1:
            raise ValueError("program needs at least one phase")
        if (self.partner < 0).any() or (self.partner >= S).any():
            raise ValueError("partner ids must lie in [0, S)")
        if (self.packets < 0).any():
            raise ValueError("packets must be >= 0")
        exp = self.expected()
        if (exp < 1).any():
            empty = int(np.argmin(exp))
            raise ValueError(
                f"phase {empty} sends no packets; an empty phase would "
                "complete instantly and desynchronize the phase scheduler")
