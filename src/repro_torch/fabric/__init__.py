"""The fabric planner: rank datacenter fabrics for a training system's
cross-pod collectives (:mod:`repro_torch.fabric.planner`)."""
from .planner import (DEFAULT_PATTERN_EFF, PATTERN_EFF, FabricSpec,
                      PodAxisPlan, build_fabric, collective_time_s,
                      load_pattern_eff, pattern_eff_from_search,
                      plan_pod_axis)

__all__ = ["DEFAULT_PATTERN_EFF", "PATTERN_EFF", "FabricSpec", "PodAxisPlan",
           "build_fabric", "collective_time_s", "load_pattern_eff",
           "pattern_eff_from_search", "plan_pod_axis"]
