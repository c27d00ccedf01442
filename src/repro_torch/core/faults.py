"""Deterministic fault injection (§5.3.3 exercised as an adversary).

A ``FaultSpec`` is a replayable schedule of failure events against the
control plane and the slot engines: server crash/restart pairs, straggler
slowdowns, silent digest corruption (Fig. 19a), and dropped offload
handoffs.  The spec is pure data — JSON-roundtrippable, generated
deterministically from a seed — so every chaos test, the hypothesis
property suite and ``make bench-chaos`` replay the exact same adversary.

The ``FaultInjector`` walks the schedule against the caller's clock and
dispatches each due event to a target implementing the ``FaultTarget``
surface (``serving/failover.py``'s ``ClusterSupervisor`` for the live
engines; the simulator applies the same spec through its event heap).
Neither side owns recovery policy here: this module only decides WHAT
breaks WHEN, never what the system does about it.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Tuple

FAULT_KINDS = ("crash", "restart", "straggle", "corrupt", "drop_offload")


@dataclasses.dataclass(frozen=True, order=True)
class FaultEvent:
    """One scheduled failure.  ``duration_s`` only matters for
    ``straggle`` (slowdown window); ``factor`` is the straggler's
    step-rate divisor or the corruption's goodput inflation; ``count``
    is the number of offload handoffs ``drop_offload`` swallows."""
    at_s: float
    kind: str
    sid: int
    duration_s: float = 0.0
    factor: float = 4.0
    count: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """An ordered, immutable fault schedule.  ``seed`` records how the
    schedule was generated (provenance only — replay never re-rolls)."""
    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events",
                           tuple(sorted(self.events)))

    def for_server(self, sid: int) -> Tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.sid == sid)

    def crashed_servers(self) -> Tuple[int, ...]:
        return tuple(sorted({e.sid for e in self.events
                             if e.kind == "crash"}))

    # -- replayable persistence -----------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed,
            "events": [dataclasses.asdict(e) for e in self.events]})

    @classmethod
    def from_json(cls, text: str) -> "FaultSpec":
        doc = json.loads(text)
        return cls(events=tuple(FaultEvent(**e) for e in doc["events"]),
                   seed=int(doc.get("seed", 0)))


def random_fault_spec(server_ids: Sequence[int], horizon_s: float, *,
                      seed: int = 0, crashes: int = 1, stragglers: int = 1,
                      corruptions: int = 1, dropped_offloads: int = 1,
                      min_alive: int = 1,
                      restart_after_s: Optional[float] = None) -> FaultSpec:
    """Deterministic seed-driven schedule generator.

    Every crash gets a paired restart (``restart_after_s`` after it, or a
    drawn fraction of the remaining horizon), and at most
    ``len(server_ids) - min_alive`` distinct servers ever crash — the
    adversary may degrade the cluster but never erase it, which is what
    keeps the served-or-verdicted property satisfiable for services
    placed on survivors."""
    if min_alive < 1:
        raise ValueError(f"min_alive must be >= 1, got {min_alive}")
    rng = random.Random(seed)
    ids = list(server_ids)
    events: List[FaultEvent] = []
    crashable = max(0, len(ids) - min_alive)
    victims = rng.sample(ids, min(crashes, crashable))
    for sid in victims:
        t = rng.uniform(0.1, 0.6) * horizon_s
        down = (restart_after_s if restart_after_s is not None
                else rng.uniform(0.1, 0.3) * horizon_s)
        events.append(FaultEvent(at_s=t, kind="crash", sid=sid))
        events.append(FaultEvent(at_s=min(t + down, horizon_s * 0.95),
                                 kind="restart", sid=sid))
    for _ in range(stragglers):
        events.append(FaultEvent(
            at_s=rng.uniform(0.05, 0.8) * horizon_s, kind="straggle",
            sid=rng.choice(ids),
            duration_s=rng.uniform(0.05, 0.2) * horizon_s,
            factor=float(rng.randint(2, 6))))
    for _ in range(corruptions):
        events.append(FaultEvent(
            at_s=rng.uniform(0.05, 0.9) * horizon_s, kind="corrupt",
            sid=rng.choice(ids), factor=rng.uniform(2.0, 8.0)))
    for _ in range(dropped_offloads):
        events.append(FaultEvent(
            at_s=rng.uniform(0.05, 0.9) * horizon_s, kind="drop_offload",
            sid=rng.choice(ids), count=rng.randint(1, 2)))
    return FaultSpec(events=tuple(events), seed=seed)


class FaultTarget(Protocol):
    """What the injector requires of the system under test."""

    def crash(self, ev: FaultEvent, now: float) -> None: ...

    def restart(self, ev: FaultEvent, now: float) -> None: ...

    def straggle(self, ev: FaultEvent, now: float) -> None: ...

    def corrupt(self, ev: FaultEvent, now: float) -> None: ...

    def drop_offload(self, ev: FaultEvent, now: float) -> None: ...


class FaultInjector:
    """Replays a ``FaultSpec`` against a monotonically advancing clock.
    ``drive(now, target)`` fires every not-yet-fired event with
    ``at_s <= now`` in schedule order; replays of the same spec against
    the same clock sequence are bit-identical by construction."""

    def __init__(self, spec: FaultSpec):
        self.spec = spec
        self._queue: List[FaultEvent] = list(spec.events)
        self._idx = 0
        self.fired: List[FaultEvent] = []

    @property
    def pending(self) -> int:
        return len(self._queue) - self._idx

    def next_at(self) -> float:
        """Schedule time of the next unfired event (inf when drained)."""
        if self._idx >= len(self._queue):
            return float("inf")
        return self._queue[self._idx].at_s

    def due(self, now: float) -> List[FaultEvent]:
        out: List[FaultEvent] = []
        while self._idx < len(self._queue) \
                and self._queue[self._idx].at_s <= now:
            out.append(self._queue[self._idx])
            self._idx += 1
        self.fired.extend(out)
        return out

    def drive(self, now: float, target: FaultTarget) -> List[FaultEvent]:
        events = self.due(now)
        for ev in events:
            getattr(target, ev.kind)(ev, now)
        return events
