"""Distributed request handler (§3.2, Fig. 6).

Pure decision logic, shared verbatim by the live serving engine and the
event-driven simulator: given a request, the local server's state, and the
(periodically synchronized, hence STALE) view of peers, decide
LOCAL / OFFLOAD(dest) / TIMEOUT / OFFLOAD_EXCEEDED / INSUFFICIENT.

Key paper semantics implemented here:
* timeout first — SLO-expired requests are dropped immediately;
* local-first, with the priority ladder  pure-local > cross-server-parallel
  local > registered-edge-device local  (§3.2);
* offloading probability  p̃_n / Σ_m p̃_m  with idle goodput
  p̃ = p̂ (theoretical) − p (actual over the stale window [−2t_n, −t_n])
  (Eq. 1);
* destination exclusion when queued compute time exceeds t_n + SLO_r;
* loop-free paths (servers already on the request's path are excluded) and
  a bounded offload count (default 5, §4.1);
* staleness-bound exclusion (§5.3.3 degraded mode): a peer whose view is
  older than ``staleness_bound_s`` is treated as DOWN, not scored on its
  last-known (possibly pre-crash) idle goodput — a silently dead server's
  frozen digest would otherwise look idle, hence maximally attractive.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, Iterable, Mapping, Optional, Tuple

# The verdict vocabulary lives in categories (one enum for handler
# decisions, engine admission verdicts and simulator counters);
# ``Outcome`` stays importable from here for the existing call sites.
from .categories import Outcome, Request, ServiceSpec
from .goodput import deadline_expired


@dataclasses.dataclass
class ServiceState:
    """Per-(server, service) scheduling state, as synchronized."""
    theoretical_goodput: float = 0.0   # p̂: deployed plan's capacity
    actual_goodput: float = 0.0        # p: measured over [-2t, -t]
    queue_time_s: float = 0.0          # expected compute time of queue
    cross_server: bool = False         # plan spans servers (lower priority)
    on_device: bool = False            # served by a registered edge device

    @property
    def idle_goodput(self) -> float:
        """p̃ = p̂ − p (Eq. 1), floored at 0."""
        return max(0.0, self.theoretical_goodput - self.actual_goodput)


@dataclasses.dataclass
class ServerView:
    """What one server believes about another (or itself, age 0)."""
    sid: int
    services: Dict[str, ServiceState] = dataclasses.field(default_factory=dict)
    sync_age_s: float = 0.0            # t_n: state information sync delay
    available: bool = True

    def state_of(self, service: str) -> Optional[ServiceState]:
        return self.services.get(service)


@dataclasses.dataclass(frozen=True)
class Decision:
    outcome: Outcome
    destination: Optional[int] = None  # server id for OFFLOAD
    reason: str = ""


class RequestHandler:
    """One per edge server; stateless across requests except for the RNG."""

    def __init__(self, sid: int, *, max_offload_count: int = 5,
                 seed: int = 0,
                 staleness_bound_s: float = float("inf")):
        if staleness_bound_s <= 0:
            raise ValueError(f"staleness_bound_s must be positive, got "
                             f"{staleness_bound_s}")
        self.sid = sid
        self.max_offload_count = max_offload_count
        self.staleness_bound_s = staleness_bound_s
        self._rng = random.Random((seed << 16) ^ sid)

    # -- Fig. 6 ----------------------------------------------------------
    def handle(self, req: Request, now: float, svc: ServiceSpec,
               local: ServerView,
               peers: Mapping[int, ServerView]) -> Decision:
        # 1) timeout
        if deadline_expired(req.deadline_s, now):
            return Decision(Outcome.TIMEOUT, reason="SLO expired")

        # 2) local first, by the §3.2 priority ladder
        local_state = local.state_of(req.service)
        if local_state is not None and self._can_serve(local_state, svc,
                                                       local.sync_age_s):
            if not local_state.cross_server and not local_state.on_device:
                return Decision(Outcome.LOCAL)
            if local_state.cross_server:
                return Decision(Outcome.LOCAL_CROSS)
            return Decision(Outcome.LOCAL_DEVICE)

        # 3) offload
        if req.offload_count >= self.max_offload_count:
            return Decision(Outcome.OFFLOAD_EXCEEDED,
                            reason=f"count={req.offload_count}")
        dest = self._pick_destination(req, svc, peers)
        if dest is not None:
            return Decision(Outcome.OFFLOAD, destination=dest)

        # 4) nothing works
        return Decision(Outcome.INSUFFICIENT)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _can_serve(state: ServiceState, svc: ServiceSpec,
                   sync_age_s: float) -> bool:
        if state.idle_goodput > 0:
            return True
        # saturated but queue still inside the SLO budget
        return state.queue_time_s <= max(0.0, svc.slo_latency_s - sync_age_s)

    def _feasible(self, req: Request, svc: ServiceSpec,
                  view: ServerView) -> bool:
        if not view.available or view.sid == self.sid:
            return False
        if view.sync_age_s > self.staleness_bound_s:
            # silent peer: its digest stopped refreshing.  The frozen view
            # still advertises pre-crash idle goodput, so scoring it would
            # ATTRACT traffic to a likely-dead server — exclude instead
            return False
        if req.on_path(view.sid):          # loop prevention
            return False
        state = view.state_of(req.service)
        if state is None:
            return False
        # exclusion: queued compute time beyond t_n + SLO_r (§3.2)
        if state.queue_time_s > view.sync_age_s + svc.slo_latency_s:
            return False
        return state.idle_goodput > 0

    def _pick_destination(self, req: Request, svc: ServiceSpec,
                          peers: Mapping[int, ServerView]) -> Optional[int]:
        candidates: list[Tuple[int, float]] = []
        for view in peers.values():
            if self._feasible(req, svc, view):
                state = view.state_of(req.service)
                candidates.append((view.sid, state.idle_goodput))
        if not candidates:
            return None
        total = sum(w for _, w in candidates)
        if total <= 0:
            return None
        x = self._rng.random() * total
        acc = 0.0
        for sid, w in candidates:
            acc += w
            if x <= acc:
                return sid
        return candidates[-1][0]

    @staticmethod
    def apply_offload(req: Request, origin: int) -> Request:
        """Record the hop on the request (path + count) — the packet-level
        bookkeeping §3.2 uses for loop prevention."""
        return dataclasses.replace(
            req, path=req.path + (origin,),
            offload_count=req.offload_count + 1)
