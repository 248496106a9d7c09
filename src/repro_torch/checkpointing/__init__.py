"""Atomic checkpoints of tensor trees (:class:`Checkpointer`), in the
reference's on-disk layout."""
from .checkpoint import Checkpointer

__all__ = ["Checkpointer"]
