"""Information synchronization (§3.4): ring topology, temporal granularity,
and the §5.3.3 error-handling behaviours.

All servers form a ring; every ``interval`` seconds each server transmits
its local digest plus its cached system-wide state to both neighbours
(ring-reduce-like), so information propagates one hop per round in each
direction and the staleness of server m's state at server n is
``ring_distance(n, m) * interval`` plus transmission time.  The handler
consumes these views with their ``sync_age_s`` — that age is exactly the
t_n in Eq. 1.

Error handling:
* ``corrupt(sid)`` — silent data error in one digest; passively corrected
  when the next genuine digest propagates (Fig. 19a);
* ``fail(sid)`` — unresponsive server; neighbours bypass it (the ring
  heals around it) and it is flagged unavailable until ``repair(sid)``.

``ParameterServerSync`` is the drop-in alternative backend (§3.4
"flexibility"): a central aggregator with uniform one-interval staleness.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from .handler import ServerView, ServiceState

DIGEST_BYTES_PER_SERVICE = 64.0
DIGEST_HEADER_BYTES = 256.0


@dataclasses.dataclass
class _CacheEntry:
    view: ServerView
    stamp: float          # local time when this state was *generated*
    corrupted: bool = False


def digest_bytes(num_services: int) -> float:
    return DIGEST_HEADER_BYTES + num_services * DIGEST_BYTES_PER_SERVICE


def sync_round_seconds(num_servers: int, num_services: int,
                       bandwidth_gbps: float) -> float:
    """Wall time for one ring exchange round (Fig. 17d's x-axis model):
    each server ships its full cached table (num_servers digests) to two
    neighbours."""
    payload = 2 * num_servers * digest_bytes(num_services)
    return payload / (bandwidth_gbps * 1e9 / 8) + 0.001


class RingSynchronizer:
    def __init__(self, server_ids: List[int], *, interval_s: float = 1.0,
                 bandwidth_gbps: float = 1.0, num_services: int = 8):
        self.ring = list(server_ids)
        self.interval_s = interval_s
        self.round_cost_s = sync_round_seconds(len(server_ids), num_services,
                                               bandwidth_gbps)
        self._failed: set[int] = set()
        # cache[n][m] = what n believes about m
        self.cache: Dict[int, Dict[int, _CacheEntry]] = {
            sid: {} for sid in server_ids}
        self._last_round = 0.0

    # -- local state publication ------------------------------------------
    def publish_local(self, sid: int, view: ServerView, now: float) -> None:
        if sid in self._failed:
            return
        self.cache[sid][sid] = _CacheEntry(view=view, stamp=now)

    # -- ring exchange ------------------------------------------------------
    def _alive_ring(self) -> List[int]:
        return [s for s in self.ring if s not in self._failed]

    def step(self, now: float) -> None:
        """One bidirectional exchange round (bypassing failed servers)."""
        ring = self._alive_ring()
        n = len(ring)
        if n <= 1:
            return
        snapshot = {sid: dict(self.cache[sid]) for sid in ring}
        for i, sid in enumerate(ring):
            for j in (i - 1, (i + 1) % n):
                peer = ring[j]
                for m, entry in snapshot[peer].items():
                    mine = self.cache[sid].get(m)
                    if mine is None or entry.stamp > mine.stamp:
                        self.cache[sid][m] = entry
        self._last_round = now

    # -- consumption ---------------------------------------------------------
    def views_for(self, sid: int, now: float) -> Dict[int, ServerView]:
        """Peer views as the handler sees them, with sync ages filled in."""
        out: Dict[int, ServerView] = {}
        for m, entry in self.cache[sid].items():
            if m == sid:
                continue
            age = max(0.0, now - entry.stamp) + self.round_cost_s
            view = dataclasses.replace(
                entry.view, sync_age_s=age,
                available=entry.view.available and m not in self._failed)
            out[m] = view
        return out

    def staleness_bound(self, sid: int, peer: int) -> float:
        """Analytic worst-case staleness: ring distance x interval."""
        ring = self._alive_ring()
        if sid not in ring or peer not in ring:
            return float("inf")
        i, j = ring.index(sid), ring.index(peer)
        d = abs(i - j)
        d = min(d, len(ring) - d)
        return d * self.interval_s + self.round_cost_s

    # -- error injection (§5.3.3) ---------------------------------------------
    def corrupt(self, sid: int, *, factor: float = 4.0) -> None:
        """Silently inflate sid's advertised idle goodput everywhere it is
        currently cached (an undetected information error)."""
        for holder in self.cache.values():
            entry = holder.get(sid)
            if entry is None:
                continue
            bad = dataclasses.replace(entry.view, services={
                k: dataclasses.replace(v, theoretical_goodput=
                                       v.theoretical_goodput * factor)
                for k, v in entry.view.services.items()})
            holder[sid] = _CacheEntry(view=bad, stamp=entry.stamp,
                                      corrupted=True)

    def fail(self, sid: int) -> None:
        self._failed.add(sid)

    def repair(self, sid: int) -> None:
        """Rejoin after a restart.  The process lost its in-memory table,
        so its cache comes back EMPTY: the restarted server re-publishes
        its own digest and re-learns peers one ring hop per round — the
        transient where the §5.3.3 staleness bound (not availability
        flags) is what protects the handler."""
        if sid in self._failed:
            self._failed.discard(sid)
            self.cache[sid] = {}

    @property
    def failed(self) -> frozenset:
        return frozenset(self._failed)


class ParameterServerSync:
    """§3.4 flexibility: central parameter-server style sync.  Every server
    sees every other with one-interval staleness; the messager is a single
    point of aggregation."""

    def __init__(self, server_ids: List[int], *, interval_s: float = 1.0):
        self.ids = list(server_ids)
        self.interval_s = interval_s
        self._table: Dict[int, _CacheEntry] = {}
        self._failed: set[int] = set()

    def publish_local(self, sid: int, view: ServerView, now: float) -> None:
        if sid not in self._failed:
            self._table[sid] = _CacheEntry(view=view, stamp=now)

    def step(self, now: float) -> None:  # aggregation is implicit
        return None

    def views_for(self, sid: int, now: float) -> Dict[int, ServerView]:
        out = {}
        for m, entry in self._table.items():
            if m == sid:
                continue
            age = max(0.0, now - entry.stamp) + self.interval_s
            out[m] = dataclasses.replace(
                entry.view, sync_age_s=age,
                available=entry.view.available and m not in self._failed)
        return out

    def corrupt(self, sid: int, **kw) -> None:
        entry = self._table.get(sid)
        if entry:
            self._table[sid] = _CacheEntry(
                view=dataclasses.replace(entry.view), stamp=entry.stamp,
                corrupted=True)

    def fail(self, sid: int) -> None:
        self._failed.add(sid)

    def repair(self, sid: int) -> None:
        # the central table survives a member restart; only the flag lifts
        self._failed.discard(sid)

    @property
    def failed(self) -> frozenset:
        return frozenset(self._failed)
