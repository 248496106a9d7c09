"""Deterministic failure schedules for fault injection.

The port's own copy of the reference's numpy module: the same events,
validation, messages, JSON form and seeded constructors, so a schedule
file loads in both packages and names the same links.

A :class:`FailureSchedule` is a frozen, JSON-round-tripped list of
:class:`FailureEvent`'s attached to a ``NetworkSpec``.  Each event takes
one element (a link or a switch) down at ``down_slot`` and, optionally,
back up at ``up_slot``.  Schedules are validated against the topology
before any simulator is built: link ids must name real ports, switch ids
must name real *non-leaf* switches (leaves host the inject/eject
endpoints and cannot die — that keeps the engine's inject/eject paths
ungated).

Link identity
-------------
A link id is the flat *directed* port index ``c * P + p`` (switch ``c``,
port ``p``, with ``P = topo.max_ports``).  Either direction of an
undirected link names the same physical link; applying a failure marks
both directions dead via ``topo.nbr_port``.  The random constructors
enumerate each undirected link once, through its canonical direction —
the endpoint whose ``(switch, port)`` pair is lexicographically smaller
(well-defined even for multi-edges, since reciprocity pairs ports).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

__all__ = ["FailureEvent", "FailureSchedule", "canonical_link_ids"]

_KINDS = ("link", "switch")
_POLICIES = ("requeue", "drop")


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One element going down (and optionally back up).

    ``kind``      — ``"link"`` or ``"switch"``.
    ``id``        — flat directed port index ``c*P + p`` for links,
                    switch index for switches.
    ``down_slot`` — slot at whose *boundary* the element goes down
                    (applied before the slot executes).
    ``up_slot``   — slot at whose boundary it comes back up; ``-1``
                    means it never recovers.
    """
    kind: str
    id: int
    down_slot: int
    up_slot: int = -1

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {self.kind!r}")
        if self.id < 0:
            raise ValueError(f"id must be >= 0, got {self.id}")
        if self.down_slot < 0:
            raise ValueError(f"down_slot must be >= 0, got {self.down_slot}")
        if self.up_slot != -1 and self.up_slot <= self.down_slot:
            raise ValueError(
                f"up_slot must be -1 (never) or > down_slot "
                f"({self.down_slot}), got {self.up_slot}")

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "id": self.id, "down_slot": self.down_slot}
        if self.up_slot != -1:
            d["up_slot"] = self.up_slot
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FailureEvent":
        return cls(kind=d["kind"], id=int(d["id"]),
                   down_slot=int(d["down_slot"]),
                   up_slot=int(d.get("up_slot", -1)))


@dataclasses.dataclass(frozen=True)
class FailureSchedule:
    """Frozen, hashable set of failure events plus a packet policy.

    ``policy`` governs packets caught on a downed element:
    ``"requeue"`` leaves them queued (they stall until the element
    recovers or, under ``policy="degraded"`` routing, are re-routed on
    their next hop); ``"drop"`` frees them immediately and counts them
    in the ``fail_drop`` counter.
    """
    events: Tuple[FailureEvent, ...] = ()
    policy: str = "requeue"

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))
        if self.policy not in _POLICIES:
            raise ValueError(
                f"policy must be one of {_POLICIES}, got {self.policy!r}")

    def __len__(self) -> int:
        return len(self.events)

    # -- validation ------------------------------------------------------
    def validate(self, topo) -> "FailureSchedule":
        """Check every event names a real element of ``topo``.

        Returns ``self`` so calls chain.  Raises ``ValueError`` on a bad
        id: link ids must be flat indices of *connected* ports, switch
        ids must be non-leaf switches.
        """
        n, p = topo.n_switches, topo.max_ports
        for ev in self.events:
            if ev.kind == "link":
                if ev.id >= n * p:
                    raise ValueError(
                        f"link id {ev.id} out of range for {n} switches "
                        f"x {p} ports")
                if topo.nbrs[ev.id // p, ev.id % p] < 0:
                    raise ValueError(
                        f"link id {ev.id} names an unconnected port "
                        f"(switch {ev.id // p}, port {ev.id % p})")
            else:
                if ev.id >= n:
                    raise ValueError(
                        f"switch id {ev.id} out of range for {n} switches")
                if topo.is_leaf[ev.id]:
                    raise ValueError(
                        f"switch id {ev.id} is a leaf; leaves host "
                        "endpoints and cannot fail")
        return self

    # -- slot-ordered transitions ---------------------------------------
    def transitions(self):
        """Yield ``(slot, downs, ups)`` sorted by slot.

        ``downs``/``ups`` are tuples of events changing state at that
        slot boundary (an event appears in ``downs`` at its
        ``down_slot`` and in ``ups`` at its ``up_slot``).
        """
        by_slot = {}
        for ev in self.events:
            by_slot.setdefault(ev.down_slot, ([], []))[0].append(ev)
            if ev.up_slot != -1:
                by_slot.setdefault(ev.up_slot, ([], []))[1].append(ev)
        return [(slot, tuple(downs), tuple(ups))
                for slot, (downs, ups) in sorted(by_slot.items())]

    # -- JSON ------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"events": [ev.to_dict() for ev in self.events],
                "policy": self.policy}

    @classmethod
    def from_dict(cls, d: dict) -> "FailureSchedule":
        return cls(events=tuple(FailureEvent.from_dict(e)
                                for e in d.get("events", ())),
                   policy=d.get("policy", "requeue"))

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FailureSchedule":
        return cls.from_dict(json.loads(s))

    # -- constructors ----------------------------------------------------
    @classmethod
    def random_links(cls, topo, count: int, down_slot: int,
                     up_slot: int = -1, seed: int = 0,
                     policy: str = "requeue") -> "FailureSchedule":
        """``count`` distinct links, uniform over the undirected links,
        all down at ``down_slot`` (and back at ``up_slot`` if given)."""
        ids = canonical_link_ids(topo)
        if count > len(ids):
            raise ValueError(
                f"asked for {count} failed links but topology has only "
                f"{len(ids)}")
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(ids), size=count, replace=False)
        events = tuple(FailureEvent("link", int(ids[i]), down_slot, up_slot)
                       for i in sorted(pick))
        return cls(events=events, policy=policy)

    @classmethod
    def random_ladder(cls, topo, count: int, start_slot: int,
                      step_slots: int, seed: int = 0, up_slot: int = -1,
                      policy: str = "requeue") -> "FailureSchedule":
        """``count`` distinct links going down one at a time: link ``k``
        fails at ``start_slot + k * step_slots``."""
        ids = canonical_link_ids(topo)
        if count > len(ids):
            raise ValueError(
                f"asked for {count} failed links but topology has only "
                f"{len(ids)}")
        if step_slots <= 0:
            raise ValueError(f"step_slots must be > 0, got {step_slots}")
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(ids), size=count, replace=False)
        events = tuple(
            FailureEvent("link", int(ids[i]), start_slot + k * step_slots,
                         up_slot)
            for k, i in enumerate(pick))
        return cls(events=events, policy=policy)


def canonical_link_ids(topo) -> np.ndarray:
    """Flat directed port ids, one per undirected link.

    The canonical direction is the endpoint with the lexicographically
    smaller ``(switch, port)`` pair — well-defined for multi-edges since
    ``nbr_port`` pairs ports one-to-one.
    """
    n, p = topo.n_switches, topo.max_ports
    c = np.repeat(np.arange(n, dtype=np.int64), p)
    pt = np.tile(np.arange(p, dtype=np.int64), n)
    nb = topo.nbrs.reshape(-1).astype(np.int64)
    nbp = topo.nbr_port.reshape(-1).astype(np.int64)
    conn = nb >= 0
    smaller = (c < nb) | ((c == nb) & (pt < nbp))
    return np.nonzero(conn & smaller)[0]
