"""Open-loop serving traffic: arrival processes, the LM request-to-traffic
bridge, and load-latency SLO sweeps.

Three layers over the simulator stack:

* the engine's ``Traffic("arrival")`` source (Poisson / bounded-Pareto /
  diurnal, :mod:`repro_torch.simulator.engine`) injects request batches
  open-loop and measures birth-to-ejection latency;
* :mod:`repro_torch.serving.bridge` compiles LM requests (prefill all-gather,
  decode point-to-point, MoE All2All) into workload programs — importing
  this package registers the ``lm_prefill`` / ``lm_decode`` / ``lm_moe``
  spec patterns;
* :mod:`repro_torch.serving.sweep` turns a :class:`ServingSpec` into the
  p50/p99/p999 vs offered-load SLO curve with its saturation knee
  (``python -m repro_torch.api serve-sweep spec.json``).

The port's copy of the reference's ``repro.serving``.
"""
from .bridge import (PACKET_BYTES, SERVING_PHASES, lm_decode_program,
                     lm_moe_program, lm_prefill_program, request_phase_shape,
                     request_to_program, request_to_spec)
from .spec import ServingSpec
from .sweep import serve_sweep, serve_sweep_many

__all__ = [
    "PACKET_BYTES",
    "SERVING_PHASES",
    "ServingSpec",
    "lm_prefill_program",
    "lm_decode_program",
    "lm_moe_program",
    "request_phase_shape",
    "request_to_program",
    "request_to_spec",
    "serve_sweep",
    "serve_sweep_many",
]
