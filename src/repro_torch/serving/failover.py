"""Request-level fault recovery (§5.3.3 made operational).

``ClusterSupervisor`` is the drive loop the launchers previously
hand-rolled, grown a failure model: it owns a ledger of every submitted
request and guarantees the served-or-verdicted invariant — every rid
ends with either a ``GenerationResult`` or an ``AdmissionReject`` whose
verdict names why (``FAILED`` when every recovery avenue is exhausted).

Recovery mechanisms, in the order they fire:

* **timeout + backoff retries** — every placement arms a deadline-derived
  timeout (``RetryPolicy``); when it expires (dropped handoff, crashed or
  straggling host) the request re-routes to the next-best peer, excluding
  already-tried servers via the handler's own loop-prevention ``path``
  bookkeeping.  Attempts are bounded; exhaustion on a dead avenue is an
  explicit ``FAILED`` verdict, never a silent drop.
* **crash evacuation** — a crashed server's engines are stripped
  (``ServiceRuntime.evacuate``): queued, in-flight and parked requests
  come back out and resubmit to survivors.  Re-prefill rides the
  survivors' radix prefix cache; PR 8's counter-stream sampling makes the
  replayed tokens bit-identical to what the dead server would have
  produced, so failover is invisible in the output.
* **duplicate dedup** — a retried request may ALSO complete on its
  original host (straggler, not corpse).  Completions are deduplicated by
  ``(rid, sample)``; the first one wins, duplicates are counted.
* **degraded-mode routing** — the control plane's staleness bound
  (``core/handler.py``) stops peers from scoring a silent server's frozen
  digest; the ring heals around flagged servers and restarts rejoin via
  ``repair_server`` + re-publish.

The supervisor implements ``core/faults.py``'s ``FaultTarget`` surface,
so a deterministic ``FaultSpec`` replays the same adversary against it in
the chaos tests, the hypothesis suite and ``make bench-chaos``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.categories import Outcome, Request
from repro_torch.core.faults import FaultEvent, FaultInjector, FaultSpec
from .admission import AdmissionReject


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Offload/handoff retry knobs.  The timeout for attempt ``a`` is
    ``base_timeout_s * backoff**a``, capped — when the request carries a
    deadline — at ``deadline_fraction`` of its remaining slack (never
    below ``base_timeout_s``: a nearly-expired request still gets one
    honest wait before its retry burns the last of the budget)."""
    base_timeout_s: float = 8.0
    backoff: float = 2.0
    max_attempts: int = 4
    deadline_fraction: float = 0.5

    def __post_init__(self):
        if self.base_timeout_s <= 0:
            raise ValueError(f"base_timeout_s must be positive, got "
                             f"{self.base_timeout_s}")
        if self.backoff < 1.0:
            raise ValueError(f"backoff must be >= 1, got {self.backoff}")
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")

    def timeout_s(self, attempt: int, deadline_s: float,
                  now: float) -> float:
        t = self.base_timeout_s * self.backoff ** max(0, attempt)
        if deadline_s and deadline_s < 1e9:
            slack = max(0.0, deadline_s - now)
            t = min(t, max(self.base_timeout_s,
                           slack * self.deadline_fraction))
        return t


@dataclasses.dataclass
class TrackedRequest:
    """Ledger entry: one submitted request and everything recovery needs
    to know about it."""
    req: Any                        # the GenerationRequest
    service: str
    origin: int                     # server the request arrived at
    server: int = -1                # current placement (-1 = none yet)
    attempts: int = 0
    timeout_at: float = float("inf")
    tried: set = dataclasses.field(default_factory=set)
    results: Dict[int, Any] = dataclasses.field(default_factory=dict)
    verdict: Optional[AdmissionReject] = None
    dropped: bool = False           # last handoff swallowed by the fault
    done: bool = False

    @property
    def open(self) -> bool:
        return not self.done


@dataclasses.dataclass
class ClusterReport:
    """What a supervised run produced, with the recovery telemetry."""
    results: List[Any] = dataclasses.field(default_factory=list)
    rejects: List[AdmissionReject] = dataclasses.field(default_factory=list)
    outcomes: Dict[str, int] = dataclasses.field(default_factory=dict)
    rounds: int = 0
    failovers: int = 0              # requests re-routed off a crash
    offload_retries: int = 0        # OFFLOAD-verdict/timeout re-routes
    duplicates: int = 0             # straggler completions deduplicated
    dropped_offloads: int = 0       # handoffs the adversary swallowed
    heartbeat_misses: int = 0       # step rounds stragglers sat out
    evacuated: int = 0              # requests stripped out of crashes

    @property
    def accounted(self) -> int:
        """Distinct rids that ended served or verdicted."""
        return len({r.rid for r in self.results}) \
            + len({r.req.rid for r in self.rejects})


class ClusterSupervisor:
    """Drives a cluster of ``EparaServingEngine``s under the control
    plane, with the recovery loop described in the module docstring.
    Implements ``core/faults.py``'s ``FaultTarget``."""

    def __init__(self, cp, engines: Dict[int, Any], *,
                 retry: Optional[RetryPolicy] = None,
                 injector: Optional[FaultInjector] = None,
                 metrics=None, tracer=None):
        self.cp = cp
        self.engines = dict(engines)
        self.retry = retry or RetryPolicy()
        self.injector = injector
        self.metrics = metrics
        self.tracer = tracer
        self.ledger: Dict[int, TrackedRequest] = {}
        self.down: set = set()
        self.report = ClusterReport()
        self._straggle: Dict[int, Tuple[float, float]] = {}
        self._drop_budget: Dict[int, int] = {}
        self._round = 0
        if metrics is not None:
            self._m = {
                "failovers": metrics.counter(
                    "cluster_failovers_total",
                    "requests re-routed off a crashed server"),
                "retries": metrics.counter(
                    "cluster_offload_retries_total",
                    "offload handoffs retried after timeout or verdict"),
                "duplicates": metrics.counter(
                    "cluster_duplicate_results_total",
                    "straggler completions deduplicated by (rid, sample)"),
                "dropped": metrics.counter(
                    "cluster_dropped_offloads_total",
                    "offload handoffs lost in flight"),
                "misses": metrics.counter(
                    "cluster_heartbeat_misses_total",
                    "step rounds a straggling server sat out"),
                "down": metrics.gauge(
                    "cluster_servers_down",
                    "servers currently flagged failed"),
            }
        else:
            self._m = None

    # -- submission -----------------------------------------------------
    def submit(self, service: str, req: Any, at_server: int,
               now: float = 0.0) -> TrackedRequest:
        """Route one request through the handler and place it.  The
        supervisor tracks it until served-or-verdicted."""
        rec = TrackedRequest(req=req, service=service, origin=at_server)
        self.ledger[req.rid] = rec
        decision = self.cp.handle(self._core_req(rec, now), now=now,
                                  at_server=at_server)
        key = decision.outcome.value
        self.report.outcomes[key] = self.report.outcomes.get(key, 0) + 1
        dest = (decision.destination
                if decision.outcome == Outcome.OFFLOAD else at_server)
        if dest is None or dest in self.down \
                or service not in self.engines[dest].runtimes:
            dest = self._any_host(service, exclude=set())
        if dest is None:
            self._fail(rec, now, reason="no alive host")
        else:
            self._place(rec, dest, now)
        return rec

    def _core_req(self, rec: TrackedRequest, now: float) -> Request:
        """Control-plane view of a tracked request: tried servers ride
        the handler's loop-prevention ``path`` so re-routes exclude
        them."""
        return Request(rid=rec.req.rid, service=rec.service,
                       arrival_s=now,
                       deadline_s=rec.req.deadline_s or 1e9,
                       path=tuple(sorted(rec.tried)),
                       offload_count=0)

    def _any_host(self, service: str, exclude: set) -> Optional[int]:
        for sid, eng in self.engines.items():
            if sid in self.down or sid in exclude:
                continue
            if service in eng.runtimes:
                return sid
        return None

    def _place(self, rec: TrackedRequest, dest: int, now: float) -> None:
        rec.attempts += 1
        rec.tried.add(dest)
        rec.server = dest
        rec.timeout_at = now + self.retry.timeout_s(
            rec.attempts - 1, rec.req.deadline_s or 0.0, now)
        budget = self._drop_budget.get(dest, 0)
        if budget > 0:
            # the adversary swallows this handoff: the request is never
            # submitted — only the armed timeout can recover it
            self._drop_budget[dest] = budget - 1
            rec.dropped = True
            self.report.dropped_offloads += 1
            if self._m:
                self._m["dropped"].inc()
            return
        rec.dropped = False
        self.engines[dest].submit(rec.service, rec.req, now)

    # -- FaultTarget ----------------------------------------------------
    def crash(self, ev: FaultEvent, now: float) -> None:
        sid = ev.sid
        if sid in self.down:
            return
        self.down.add(sid)
        self.cp.fail_server(sid, now)
        evacuated: List[Any] = []
        for rt in self.engines[sid].runtimes.values():
            evacuated.extend(rt.evacuate(now))
        self.report.evacuated += len(evacuated)
        if self.tracer is not None:
            self.tracer.instant("cluster", f"server{sid}", "crash",
                                evacuated=len(evacuated))
        for req in evacuated:
            rec = self.ledger.get(req.rid)
            if rec is None or rec.done:
                continue
            self.report.failovers += 1
            if self._m:
                self._m["failovers"].inc()
            self._reroute(rec, now, reason="crash")
        # any ledger entry still pointed at the corpse (e.g. placed but
        # dropped before submission) retries through its timeout
        if self._m:
            self._m["down"].set(float(len(self.down)))

    def restart(self, ev: FaultEvent, now: float) -> None:
        if ev.sid not in self.down:
            return
        self.down.discard(ev.sid)
        self.cp.repair_server(ev.sid, now)
        if self.tracer is not None:
            self.tracer.instant("cluster", f"server{ev.sid}", "restart")
        if self._m:
            self._m["down"].set(float(len(self.down)))

    def straggle(self, ev: FaultEvent, now: float) -> None:
        self._straggle[ev.sid] = (now + ev.duration_s,
                                  max(1.0, ev.factor))

    def corrupt(self, ev: FaultEvent, now: float) -> None:
        self.cp.sync.corrupt(ev.sid, factor=ev.factor)

    def drop_offload(self, ev: FaultEvent, now: float) -> None:
        self._drop_budget[ev.sid] = \
            self._drop_budget.get(ev.sid, 0) + ev.count

    # -- recovery -------------------------------------------------------
    def _reroute(self, rec: TrackedRequest, now: float,
                 reason: str) -> None:
        """Find the next-best placement for an open request.  Attempt
        budget exhausted: FAILED only when its current avenue is dead
        (crashed host / swallowed handoff / nowhere left) — a healthy but
        slow host keeps running with the timeout disarmed."""
        avenue_dead = (rec.dropped or rec.server in self.down
                       or rec.server < 0)
        if rec.attempts >= self.retry.max_attempts:
            if avenue_dead:
                self._fail(rec, now, reason=f"retry budget exhausted "
                                            f"({reason})")
            else:
                rec.timeout_at = float("inf")
            return
        decision = self.cp.handle(self._core_req(rec, now), now=now,
                                  at_server=rec.origin
                                  if rec.origin not in self.down
                                  else next(iter(
                                      set(self.engines) - self.down),
                                      rec.origin))
        dest: Optional[int] = None
        if decision.outcome == Outcome.OFFLOAD:
            dest = decision.destination
        elif decision.outcome in (Outcome.LOCAL, Outcome.LOCAL_CROSS,
                                  Outcome.LOCAL_DEVICE):
            dest = rec.origin
        if dest is not None and (dest in self.down
                                 or rec.service not in
                                 self.engines[dest].runtimes):
            dest = None
        if dest is None:
            # handler has no scored candidate — fall back to any alive
            # host, preferring untried ones, but never double-submit to a
            # server that may still be running this rid
            exclude = set(rec.tried)
            if not avenue_dead:
                exclude.add(rec.server)
            dest = self._any_host(rec.service, exclude=exclude)
            if dest is None and avenue_dead:
                dest = self._any_host(rec.service,
                                      exclude={rec.server})
        if dest is None:
            if avenue_dead:
                self._fail(rec, now, reason=f"no alive host ({reason})")
            else:
                rec.timeout_at = float("inf")
            return
        if self.tracer is not None:
            self.tracer.instant("cluster", str(rec.req.rid), "failover",
                                to=dest, reason=reason,
                                attempt=rec.attempts)
        self._place(rec, dest, now)

    def _fail(self, rec: TrackedRequest, now: float, reason: str) -> None:
        rec.done = True
        rec.timeout_at = float("inf")
        rec.verdict = AdmissionReject(
            req=rec.req, verdict=Outcome.FAILED, now=now, reason=reason,
            attempts=rec.attempts)
        self.report.rejects.append(rec.verdict)
        key = Outcome.FAILED.value
        self.report.outcomes[key] = self.report.outcomes.get(key, 0) + 1

    def _record_reject(self, rec: TrackedRequest,
                       rj: AdmissionReject) -> None:
        rec.done = True
        rec.timeout_at = float("inf")
        rec.verdict = dataclasses.replace(rj, attempts=rec.attempts)
        self.report.rejects.append(rec.verdict)

    def _collect(self, sid: int, service: str, stats: Any,
                 now: float) -> None:
        for res in stats.results:
            rec = self.ledger.get(res.rid)
            if rec is None:
                self.report.results.append(res)
                continue
            if res.sample in rec.results:
                # the straggler ALSO finished it — first completion won
                self.report.duplicates += 1
                if self._m:
                    self._m["duplicates"].inc()
                continue
            rec.results[res.sample] = res
            self.report.results.append(res)
            if res.sample == 0:
                rec.done = True
                rec.timeout_at = float("inf")
        for rj in stats.rejected:
            rec = self.ledger.get(rj.req.rid)
            if rec is None or rec.done:
                continue
            if rj.verdict is Outcome.OFFLOAD:
                # routable, not dead: the handler picks the next peer
                self.report.offload_retries += 1
                if self._m:
                    self._m["retries"].inc()
                rec.dropped = True      # not running anywhere right now
                self._reroute(rec, now, reason="offload verdict")
            else:
                self._record_reject(rec, rj)

    # -- drive loop -----------------------------------------------------
    def step(self, now: float) -> bool:
        """One cluster round: fire due faults, step every alive engine,
        feed queue-time back to the handler state, run the sync round,
        and fire expired retry timeouts.  Returns True when any engine
        made progress."""
        self._round += 1
        if self.injector is not None:
            self.injector.drive(now, self)
        progress = False
        for sid, eng in self.engines.items():
            if sid in self.down:
                continue
            until_factor = self._straggle.get(sid)
            if until_factor is not None:
                until, factor = until_factor
                if now >= until:
                    del self._straggle[sid]
                elif self._round % int(factor) != 0:
                    # the straggler only gets every factor-th round
                    self.report.heartbeat_misses += 1
                    if self._m:
                        self._m["misses"].inc()
                    continue
            for name, rt in eng.runtimes.items():
                if not (rt.pending() or rt.in_flight()):
                    continue
                stats = rt.step(now=now, max_wait_s=0.0)
                self.cp.set_queue_time(sid, name, stats.queue_time_s)
                self._collect(sid, name, stats, now)
                if (stats.results or stats.admitted or stats.decode_steps
                        or stats.prefill_chunk_tokens or stats.rejected
                        or stats.verify_launches or stats.draft_steps):
                    progress = True
        self.cp.publish_all(now)
        self.cp.sync_step(now)
        for rec in list(self.ledger.values()):
            if rec.open and now >= rec.timeout_at:
                self.report.offload_retries += 1
                if self._m:
                    self._m["retries"].inc()
                self._reroute(rec, now, reason="timeout")
        return progress

    def open_requests(self) -> List[TrackedRequest]:
        return [r for r in self.ledger.values() if r.open]

    def run_until_idle(self, now: float = 0.0, dt: float = 1.0,
                       clock: Optional[Callable[[], float]] = None,
                       max_rounds: int = 100000) -> ClusterReport:
        """Drive until every tracked rid is served-or-verdicted.  With a
        ``clock`` the caller's wall time advances ``now``; otherwise a
        logical clock steps by ``dt`` and JUMPS over idle gaps to the
        next armed timeout or scheduled fault, so backoff waits cost
        rounds, not wall time."""
        stall = 0
        for _ in range(max_rounds):
            if not self.open_requests():
                break
            now = clock() if clock is not None else now + dt
            progress = self.step(now)
            if progress:
                stall = 0
                continue
            stall += 1
            if clock is None:
                horizon = [r.timeout_at for r in self.open_requests()
                           if r.timeout_at < float("inf")]
                if self.injector is not None \
                        and self.injector.next_at() < float("inf"):
                    horizon.append(self.injector.next_at())
                if horizon:
                    now = max(now, min(horizon))
                    stall = 0
                    progress = self.step(now)
                    if progress:
                        continue
            if stall >= 3:
                # nothing can move: engines idle, no timeout or fault
                # left to jump to — verdict the stranded remainder
                for rec in self.open_requests():
                    self._fail(rec, now, reason="stranded (no progress)")
        else:
            for rec in self.open_requests():
                self._fail(rec, now, reason="round budget exhausted")
        # drain faults scheduled past the last served request: a
        # crash/restart pair must leave the cluster healed even when the
        # burst finishes before the restart's timestamp
        if self.injector is not None:
            while self.injector.next_at() < float("inf"):
                now = max(now, self.injector.next_at())
                self.injector.drive(now, self)
                self.cp.publish_all(now)
                self.cp.sync_step(now)
        self.report.rounds = self._round
        return self.report
