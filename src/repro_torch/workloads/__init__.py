"""Workload-pattern registry."""
from .patterns import (ARRIVAL_PATTERNS, BERNOULLI_PATTERNS,
                       COLLECTIVE_PATTERNS, ENGINE_PATTERNS, check_arrival,
                       check_engine_pattern, check_pattern, check_schedule)

__all__ = ["ARRIVAL_PATTERNS", "BERNOULLI_PATTERNS", "COLLECTIVE_PATTERNS",
           "ENGINE_PATTERNS", "check_arrival", "check_engine_pattern",
           "check_pattern", "check_schedule"]
