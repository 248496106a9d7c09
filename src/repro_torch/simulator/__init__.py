"""The cycle-level switch model."""
from .engine import (LATENCY_QS, POLICIES, SimConfig, Simulator, Traffic,
                     percentiles)

__all__ = ["LATENCY_QS", "POLICIES", "SimConfig", "Simulator", "Traffic",
           "percentiles"]
