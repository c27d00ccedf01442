"""Goodput / SLO accounting (§3.3 semantics).

* latency-sensitive task: satisfied iff it completes within its SLO.
* frequency-sensitive task: partial credit — a stream of F frames with an
  SLO of f* fps served at f fps counts F * min(f, f*) / f* satisfied
  requests (the paper's 120-frame / 60-fps / 30-fps => 60 example).

``GoodputMeter`` also maintains the windowed *actual* goodput p over the
staleness interval [-2t, -t] that Eq. 1 subtracts from p̂.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

from .categories import Request, Sensitivity, ServiceSpec


def latency_satisfied(finish_s: float, deadline_s: float) -> bool:
    return finish_s <= deadline_s


def deadline_expired(deadline_s: float, now: float) -> bool:
    """Shared expiry predicate: True when a request carrying a deadline
    can no longer be satisfied (``deadline_s == 0`` means "no deadline").
    The single home for the ``deadline and now > deadline`` check that
    the handler, every baseline scheduler, the simulator and the
    admission controller all apply before spending any work."""
    return bool(deadline_s) and not latency_satisfied(now, deadline_s)


def frequency_credit(frames: int, achieved_fps: float,
                     slo_fps: float) -> float:
    """F * min(f, f*) / f*  (Eq. 2's y accounting for frequency tasks)."""
    if slo_fps <= 0:
        return float(frames)
    return frames * min(achieved_fps, slo_fps) / slo_fps


@dataclasses.dataclass
class CompletionRecord:
    service: str
    t: float            # completion time
    credit: float       # satisfied-request credit (1 or partial frames)
    violated: bool


class GoodputMeter:
    """Streaming goodput accounting per service + whole system."""

    def __init__(self):
        self._records: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)   # service -> [(t, credit)]
        self.total_credit = 0.0
        self.total_offered = 0.0
        self.violations = 0

    # -- recording -------------------------------------------------------
    def offered(self, req: Request) -> None:
        self.total_offered += req.frames

    def complete_latency(self, req: Request, finish_s: float) -> float:
        ok = latency_satisfied(finish_s, req.deadline_s) \
            if req.deadline_s else True
        credit = 1.0 if ok else 0.0
        if not ok:
            self.violations += 1
        self._push(req.service, finish_s, credit)
        return credit

    def complete_frequency(self, req: Request, finish_s: float,
                           achieved_fps: float, slo_fps: float) -> float:
        credit = frequency_credit(req.frames, achieved_fps, slo_fps)
        if credit < req.frames:
            self.violations += 1
        self._push(req.service, finish_s, credit)
        return credit

    def drop(self, req: Request, t: float) -> None:
        self.violations += 1
        self._push(req.service, t, 0.0)

    def _push(self, service: str, t: float, credit: float) -> None:
        """Records are (t, cumulative_credit); completions arrive in event
        order (a min-heap), so times are nondecreasing and windowed sums
        are two bisects over the prefix array — O(log n) instead of the
        O(n) scan that made 16-server/600k-event sims quadratic."""
        recs = self._records[service]
        prev = recs[-1][1] if recs else 0.0
        if recs and t < recs[-1][0]:
            t = recs[-1][0]          # clamp stragglers; keeps monotonicity
        recs.append((t, prev + credit))
        self.total_credit += credit

    # -- queries ------------------------------------------------------------
    def _cum_at(self, recs, t: float) -> float:
        """Cumulative credit of records with time < t."""
        lo, hi = 0, len(recs)
        while lo < hi:
            mid = (lo + hi) // 2
            if recs[mid][0] < t:
                lo = mid + 1
            else:
                hi = mid
        return recs[lo - 1][1] if lo else 0.0

    def goodput(self, service: str, *, window: Tuple[float, float]) -> float:
        """Actual goodput p over [window): credits/sec.  Called by the sync
        layer with window = [now - 2t, now - t] (Eq. 1)."""
        lo, hi = window
        if hi <= lo:
            return 0.0
        recs = self._records.get(service)
        if not recs:
            return 0.0
        total = self._cum_at(recs, hi) - self._cum_at(recs, lo)
        return total / (hi - lo)

    def service_total(self, service: str) -> float:
        recs = self._records.get(service)
        return recs[-1][1] if recs else 0.0

    def system_goodput(self, horizon_s: float) -> float:
        return self.total_credit / horizon_s if horizon_s > 0 else 0.0

    @property
    def fulfillment_ratio(self) -> float:
        if self.total_offered <= 0:
            return 1.0
        return min(1.0, self.total_credit / self.total_offered)
