"""Data: the deterministic synthetic LM stream (:mod:`.pipeline`)."""
from .pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
