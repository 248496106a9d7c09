"""Topology-family resolution for :class:`NetworkSpec`."""
from __future__ import annotations

from ..core import TOPOLOGY_FAMILIES
from ..core.topology import Topology
from .specs import NetworkSpec

__all__ = ["topology_families", "build_network"]

# families of the reference that come with later slices
_LATER_FAMILIES = ("oft", "rfc", "jellyfish")


def topology_families() -> tuple:
    return tuple(sorted(TOPOLOGY_FAMILIES))


def build_network(spec: NetworkSpec) -> Topology:
    """Resolve ``spec.family`` and build the topology from ``spec.params``."""
    make = TOPOLOGY_FAMILIES.get(spec.family)
    if make is None:
        if spec.family in _LATER_FAMILIES:
            raise NotImplementedError(
                f"topology family {spec.family!r} is not ported yet; the "
                f"port builds {topology_families()}")
        raise KeyError(f"unknown topology family {spec.family!r}; known: "
                       f"{topology_families()}")
    return make(**spec.param_dict())
