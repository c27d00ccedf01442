"""Event-driven edge-cloud co-simulation (§5.2 methodology).

The simulator "fully executes the request scheduling process but bypasses
actual packet transmission and model computation": transmission latency is
priced from payload/bandwidth, computation latency from the shared roofline
cost model (repro_torch.core.costmodel) — both identical to what the control
plane itself believes, so scheduler quality (not cost-model mismatch) is
what the experiments measure.

Execution model per (server, service): capacity c reqs/s from the placed
plans; latency requests flow through a virtual single-queue (finish = max
(now, vf) + 1/c + base latency); frequency streams reserve fps for their
duration (partial credit at stream end via ``frequency_credit``).  Only
request-level schedulers (EPARA) may split one stream across replica
groups/servers — the Fig. 1 effect.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core import costmodel as cm
from repro_torch.core.allocator import plan_goodput
from repro_torch.core.categories import (GPUSpec, Outcome, Request, ServerSpec,
                                   ServiceSpec)
from repro_torch.core.cluster import EdgeCloudControlPlane
from repro_torch.core.goodput import (GoodputMeter, deadline_expired,
                                frequency_credit)
from repro_torch.core.placement import EPSILON_SERVER

from .baselines import Route, Scheduler
from .workload import demand_matrix


@dataclasses.dataclass
class SimConfig:
    horizon_s: float = 120.0
    sync_interval_s: float = 1.0
    placement_interval_s: float = 60.0
    inter_server_bw_gbs: float = 1.25
    seed: int = 0
    # data-plane service discipline for latency tasks, mirroring the live
    # engine's three paths.  "paged" (the arena data plane) admits as
    # capacity frees with zero admission overhead: pure 1/c fluid flow.
    # "continuous" is the dense slot loop: the same fluid flow plus
    # ``admission_copy_s`` per admission (the kvcache.merge whole-batch
    # copy + retrace stall the arena removes; 0 by default so legacy
    # configs are unchanged).  "sync" models the pre-slot run-to-completion
    # engine: requests barrier until a full ``bs`` batch forms (or
    # ``sync_flush_s`` passes) and every member holds its slot for the
    # full batch latency.
    serving_mode: str = "paged"
    sync_flush_s: float = 0.05
    admission_copy_s: float = 0.0
    # chunked-prefill cost model (paged/continuous latency service): an
    # admission's prompt costs ``prompt_tokens * prefill_token_s`` of
    # serial prefill work.  Unchunked (prefill_chunk_tokens = 0) the WHOLE
    # prompt stalls the service's virtual queue in one piece — every live
    # request behind it waits (head-of-line blocking).  Chunked, the stall
    # imposed on the shared queue is capped at one chunk
    # (``min(prompt, chunk) * prefill_token_s``): the remaining chunks
    # interleave with decode steps, so only the arriving request itself
    # pays for them.  Placement sees the effect through goodput/queue
    # delay; ``SimResult.max_prefill_stall_s`` reports the worst stall.
    prefill_chunk_tokens: int = 0
    prefill_token_s: float = 0.0
    # radix prefix cache (live engine's shared-prefix KV reuse): the
    # expected fraction of an admission's prompt tokens served from cached
    # blocks instead of prefill compute.  Applied only to services whose
    # plan enables the cache (``ParallelPlan.prefix_cache != 0``), so SSSP
    # placement prices repeated-prefix (frequency) workloads at their
    # post-reuse prefill cost — reuse-aware capacity feeds placement
    # quality.  ``SimResult.cached_prefill_s`` reports the total prefill
    # seconds the cache removed.
    prefix_hit_rate: float = 0.0
    # per-service hit rates derived from the workload's actual template-
    # repeat structure (``workload.derive_prefix_hit_rates``); a service
    # present here overrides the scalar ``prefix_hit_rate``, absent
    # services fall back to it.  None = scalar-only (legacy configs).
    prefix_hit_rates: Optional[Mapping[str, float]] = None
    # request-admission policy for latency tasks on the paged/continuous
    # data plane, mirroring the live engine's ``ParallelPlan.admission``
    # knob.  "fifo" (legacy): every arrival joins the fluid queue, doomed
    # requests burn capacity and finish late.  "sdf" (Strictest-Deadline-
    # First): arrivals whose own service time alone exceeds the remaining
    # deadline budget are shed with a DEADLINE_MISSED verdict (no capacity
    # spent), and arrivals that would miss only because of queue wait
    # preempt — jump the virtual queue at ``preempt_overhead_s`` extra
    # latency (the park/resume block-table cost) while the displaced work
    # still occupies the server, so SSSP placement prices preemption.
    admission_policy: str = "fifo"
    preempt_overhead_s: float = 0.0005
    # speculative decoding (live engine's draft/verify rounds): a round
    # proposes k draft tokens and commits 1 + accept_rate*k of them per
    # fused target launch, at ``spec_draft_cost`` target-step-fractions
    # per draft step.  The decode term of a speculating latency service is
    # scaled by (1 + draft_cost*(k+1)) / (1 + accept_rate*k) — the
    # acceptance-rate-discounted serial-launch count.  Both fields default
    # 0 => factor 1 (legacy configs unchanged); k comes from the plan's
    # ``resolved_speculate`` knob, so only services whose category/plan
    # actually speculates are discounted.
    spec_accept_rate: float = 0.0
    spec_draft_cost: float = 0.0
    # deterministic failure processes (core/faults.py FaultSpec): the
    # same replayable schedule the live ClusterSupervisor consumes, run
    # through the event heap.  A crash zeroes the server's capacity and
    # flags it in the control plane (the ring heals around it; peers
    # stop scoring its frozen digest past the staleness bound); work
    # admitted before the crash but unfinished at it is LOST and
    # resubmits through the handler after ``failover_retry_s`` — or
    # draws a FAILED verdict when its deadline already passed.  A
    # restart lifts the flag immediately (ring rejoin + re-publish) but
    # capacity only returns after ``restart_reload_s`` (weight reload).
    # ``drop_offload`` swallows handoffs TO the named server; the origin
    # retries them after the same delay.  None = fault-free (legacy).
    fault_spec: Optional[object] = None
    restart_reload_s: float = 2.0
    failover_retry_s: float = 0.5


@dataclasses.dataclass
class SimResult:
    scheduler: str
    goodput: float              # satisfied credits / sec
    offered: float
    fulfillment: float
    violations: int
    offload_counts: List[int]
    handled: int

    first_hops: int = 1
    max_prefill_stall_s: float = 0.0   # worst single-admission prefill
    #                                    stall imposed on live requests
    cached_prefill_s: float = 0.0      # prefill seconds removed by the
    #                                    prefix cache (hit-rate model)
    verdicts: Dict[str, int] = dataclasses.field(default_factory=dict)
    #                                  # admission-verdict counts (Outcome
    #                                    values) under the "sdf" policy
    preemptions: int = 0               # queue-jump admissions (modeled
    #                                    block-table-parking preemptions)
    spec_discounted: int = 0           # requests priced at the
    #                                    speculative-decoding discount
    crashes: int = 0                   # injected server crashes
    failover_resubmits: int = 0        # requests whose in-flight compute
    #                                    a crash (or dropped handoff)
    #                                    destroyed, rerouted to survivors
    dropped_offloads: int = 0          # handoffs the adversary swallowed

    @property
    def mean_offloads(self) -> float:
        """Offload hops per arriving request (the paper's Fig. 17e metric:
        <1 when sync is fresh; grows with staleness)."""
        return len(self.offload_counts) / max(1, self.first_hops)


class _ServerState:
    __slots__ = ("capacity", "vf", "stream_load", "forming", "forming_gen")

    def __init__(self):
        self.capacity: Dict[str, float] = {}
        self.vf: Dict[str, float] = {}          # virtual finish per service
        self.stream_load: Dict[str, float] = {}  # reserved fps
        self.forming: Dict[str, list] = {}       # sync mode: batch barrier
        self.forming_gen: Dict[str, int] = {}    # guards stale flush events


class Simulation:
    def __init__(self, servers: Sequence[ServerSpec],
                 services: Mapping[str, ServiceSpec],
                 scheduler: Scheduler,
                 events: Sequence[Tuple[float, int, Request]],
                 cfg: SimConfig = SimConfig()):
        self.servers = list(servers)
        self.services = dict(services)
        self.scheduler = scheduler
        self.cfg = cfg
        if cfg.serving_mode not in ("paged", "continuous", "sync"):
            raise ValueError(
                f"serving_mode must be paged|continuous|sync, got "
                f"{cfg.serving_mode!r}")
        if not 0.0 <= cfg.prefix_hit_rate < 1.0:
            raise ValueError(
                f"prefix_hit_rate must be in [0, 1), got "
                f"{cfg.prefix_hit_rate!r}")
        for name, r in (cfg.prefix_hit_rates or {}).items():
            if not 0.0 <= r < 1.0:
                raise ValueError(
                    f"prefix_hit_rates[{name!r}] must be in [0, 1), got "
                    f"{r!r}")
        if cfg.admission_policy not in ("fifo", "sdf"):
            raise ValueError(
                f"admission_policy must be fifo|sdf, got "
                f"{cfg.admission_policy!r}")
        self.meter = GoodputMeter()
        self.server_ids = [s.sid for s in self.servers]
        self.state: Dict[int, _ServerState] = {
            s.sid: _ServerState() for s in self.servers}
        self.control_plane = EdgeCloudControlPlane(
            self.servers, self.services,
            sync_interval_s=cfg.sync_interval_s,
            placement_interval_s=cfg.placement_interval_s, seed=cfg.seed)
        # EPARA's control plane must use the scheduler's plans
        self.control_plane.plans = dict(scheduler.plans)
        self._events = sorted(events, key=lambda e: e[0])
        self._heap: List[Tuple[float, int, str, tuple]] = []
        self._seq = itertools.count()
        self._offload_counts: List[int] = []
        self._handled = 0
        self._first_hops = 0
        self._max_prefill_stall = 0.0
        self._cached_prefill_s = 0.0
        self._verdicts: Dict[str, int] = {}
        self._preemptions = 0
        self._spec_discounted = 0
        self.placements: List[Tuple[str, int]] = []
        # failure-process state: crash times per sid (a done event whose
        # host crashed inside its (admit, finish) window lost its compute)
        self._down: set = set()
        self._crash_times: Dict[int, List[float]] = {}
        self._saved_capacity: Dict[int, Dict[str, float]] = {}
        self._drop_budget: Dict[int, int] = {}
        self._crashes = 0
        self._failover_resubmits = 0
        self._dropped_offloads = 0

    def _note_verdict(self, outcome: Outcome) -> None:
        key = outcome.value
        self._verdicts[key] = self._verdicts.get(key, 0) + 1

    # ------------------------------------------------------------------
    # context interface consumed by baseline schedulers
    # ------------------------------------------------------------------
    def is_placed(self, sid: int, service: str) -> bool:
        return self.state[sid].capacity.get(service, 0.0) > 0

    def has_capacity(self, sid: int, service: str, now: float) -> bool:
        st = self.state[sid]
        cap = st.capacity.get(service, 0.0) - st.stream_load.get(service, 0.0)
        if cap <= 0:
            return False
        svc = self.services[service]
        return self.queue_time(sid, service, now) <= svc.slo_latency_s

    def queue_time(self, sid: int, service: str, now: float) -> float:
        st = self.state[sid]
        return max(0.0, st.vf.get(service, 0.0) - now)

    # ------------------------------------------------------------------
    def _apply_placement(self, placements, now: float) -> None:
        self.placements = list(placements)
        self.control_plane.placements = list(placements)
        gpu = self.servers[0].gpu
        for st in self.state.values():
            st.capacity.clear()
        pooled: Dict[str, float] = {}
        for svc_name, sid in placements:
            svc = self.services[svc_name]
            plan = self.scheduler.plans[svc_name]
            g = plan_goodput(svc, gpu, plan,
                             cross_server=(sid == EPSILON_SERVER))
            if sid == EPSILON_SERVER:
                pooled[svc_name] = pooled.get(svc_name, 0.0) + g
            else:
                cap = self.state[sid].capacity
                cap[svc_name] = cap.get(svc_name, 0.0) + g
        # ε capacity: spread across the least-loaded servers
        for svc_name, g in pooled.items():
            share = g / len(self.servers)
            for st in self.state.values():
                st.capacity[svc_name] = st.capacity.get(svc_name, 0.0) + share

    # ------------------------------------------------------------------
    def run(self) -> SimResult:
        cfg = self.cfg
        # initial placement from the full offered demand (offline mode §3.3)
        demand = demand_matrix(self._events, self.services, cfg.horizon_s)
        placements = self.scheduler.place(
            self.control_plane.build_problem(demand))
        self._apply_placement(placements, 0.0)

        push = lambda t, kind, payload: heapq.heappush(
            self._heap, (t, next(self._seq), kind, payload))
        for t, sid, req in self._events:
            self.meter.offered(req)
            push(t, "arrival", (sid, req))
        t = cfg.sync_interval_s
        while t < cfg.horizon_s:
            push(t, "sync", ())
            t += cfg.sync_interval_s
        if cfg.fault_spec is not None:
            for ev in cfg.fault_spec.events:
                push(ev.at_s, "fault", (ev,))

        while self._heap:
            now, _, kind, payload = heapq.heappop(self._heap)
            if kind == "sync":
                self.control_plane.publish_all(now)
                self.control_plane.sync_step(now)
            elif kind == "arrival":
                sid, req = payload
                self._handle(req, sid, now, push)
            elif kind == "done":
                req, finish, sid, admit_t = payload
                if self._crashed_during(sid, admit_t, finish):
                    # the host died under it: the virtual queue's compute
                    # never happened — reroute to a survivor (or FAILED)
                    self._resubmit(req, sid, now, push)
                else:
                    self.meter.complete_latency(req, finish)
            elif kind == "fault":
                self._apply_fault(payload[0], now, push)
            elif kind == "reload":
                sid = payload[0]
                saved = self._saved_capacity.pop(sid, None)
                if saved is not None and sid not in self._down:
                    self.state[sid].capacity = saved
            elif kind == "fault_restore":
                sid, factor = payload
                for table in (self.state[sid].capacity,
                              self._saved_capacity.get(sid)):
                    if table:
                        for k in table:
                            table[k] *= factor
            elif kind == "batch_flush":
                sid, service, gen = payload
                st = self.state[sid]
                if (st.forming_gen.get(service, 0) == gen
                        and st.forming.get(service)):
                    self._dispatch_batch(sid, service, now, push)
            elif kind == "stream_end":
                req, achieved, sid = payload
                svc = self.services[req.service]
                st = self.state[sid]
                st.stream_load[req.service] = max(
                    0.0, st.stream_load.get(req.service, 0.0) - achieved)
                start = now - req.duration_s
                for t_c in self._crash_times.get(sid, ()):
                    if start <= t_c <= now:
                        # partial credit: frames delivered before the host
                        # crashed; the rest of the stream died with it
                        achieved *= max(0.0, (t_c - start)
                                        / max(1e-9, req.duration_s))
                        break
                self.meter.complete_frequency(req, now, achieved,
                                              svc.slo_fps)
        horizon = cfg.horizon_s
        return SimResult(
            scheduler=self.scheduler.name,
            goodput=self.meter.total_credit / horizon,
            offered=self.meter.total_offered / horizon,
            fulfillment=self.meter.fulfillment_ratio,
            violations=self.meter.violations,
            offload_counts=self._offload_counts,
            handled=self._handled, first_hops=max(1, self._first_hops),
            max_prefill_stall_s=self._max_prefill_stall,
            cached_prefill_s=self._cached_prefill_s,
            verdicts=dict(self._verdicts),
            preemptions=self._preemptions,
            spec_discounted=self._spec_discounted,
            crashes=self._crashes,
            failover_resubmits=self._failover_resubmits,
            dropped_offloads=self._dropped_offloads)

    # ------------------------------------------------------------------
    # failure processes (core/faults.py schedules on the event heap)
    # ------------------------------------------------------------------
    def _crashed_during(self, sid: int, start: float, end: float) -> bool:
        return any(start <= t <= end
                   for t in self._crash_times.get(sid, ()))

    def _resubmit(self, req: Request, dead_sid: int, now: float,
                  push) -> None:
        """Recover a request whose compute a fault destroyed: reroute it
        through the handler from a surviving server after the retry
        delay — or issue the explicit FAILED verdict when its deadline
        (or the cluster) is already gone."""
        retry_at = now + self.cfg.failover_retry_s
        alive = [s for s in self.server_ids if s not in self._down]
        if not alive or deadline_expired(req.deadline_s, retry_at):
            self._note_verdict(Outcome.FAILED)
            self.meter.drop(req, now)
            return
        from repro_torch.core.handler import RequestHandler
        fwd = RequestHandler.apply_offload(req, dead_sid)
        self._failover_resubmits += 1
        push(retry_at, "arrival", (alive[0], fwd))

    def _apply_fault(self, ev, now: float, push) -> None:
        st = self.state.get(ev.sid)
        if st is None:
            return
        if ev.kind == "crash":
            if ev.sid in self._down:
                return
            self._down.add(ev.sid)
            self._crashes += 1
            self._crash_times.setdefault(ev.sid, []).append(now)
            self.control_plane.fail_server(ev.sid, now)
            self._saved_capacity[ev.sid] = dict(st.capacity)
            st.capacity = {}
            st.vf.clear()
            st.stream_load.clear()
            # sync-mode batch barriers on the corpse: members resubmit
            for service, forming in list(st.forming.items()):
                st.forming_gen[service] = \
                    st.forming_gen.get(service, 0) + 1
                for req in forming:
                    self._resubmit(req, ev.sid, now, push)
                st.forming[service] = []
        elif ev.kind == "restart":
            if ev.sid not in self._down:
                return
            self._down.discard(ev.sid)
            # ring rejoin is immediate; serving capacity only returns
            # after the weight reload
            self.control_plane.repair_server(ev.sid, now)
            push(now + self.cfg.restart_reload_s, "reload", (ev.sid,))
        elif ev.kind == "straggle":
            factor = max(1.0, ev.factor)
            for table in (st.capacity, self._saved_capacity.get(ev.sid)):
                if table:
                    for k in table:
                        table[k] /= factor
            push(now + ev.duration_s, "fault_restore", (ev.sid, factor))
        elif ev.kind == "corrupt":
            self.control_plane.sync.corrupt(ev.sid, factor=ev.factor)
        elif ev.kind == "drop_offload":
            self._drop_budget[ev.sid] = \
                self._drop_budget.get(ev.sid, 0) + ev.count

    # ------------------------------------------------------------------
    def _handle(self, req: Request, sid: int, now: float, push) -> None:
        self._handled += 1
        if req.offload_count == 0:
            self._first_hops += 1
        svc = self.services[req.service]
        sched_lat = self.scheduler.scheduling_latency(len(self.servers))
        now = now + sched_lat
        route = self.scheduler.route(req, sid, now, self)
        if route.outcome == Outcome.TIMEOUT or deadline_expired(
                req.deadline_s, now):
            self._note_verdict(Outcome.TIMEOUT)
            self.meter.drop(req, now)
            return
        if route.outcome in (Outcome.OFFLOAD,):
            dest = route.destination
            budget = self._drop_budget.get(dest, 0)
            if budget > 0:
                # the adversary swallows this handoff in flight; the
                # origin notices the missing ack and retries its routing
                self._drop_budget[dest] = budget - 1
                self._dropped_offloads += 1
                self._failover_resubmits += 1
                push(now + self.cfg.failover_retry_s, "arrival",
                     (sid, req))
                return
            hop = cm.transfer_time(svc.request_bytes,
                                   self.cfg.inter_server_bw_gbs)
            from repro_torch.core.handler import RequestHandler
            fwd = RequestHandler.apply_offload(req, sid)
            self._offload_counts.append(fwd.offload_count)
            push(now + hop, "arrival", (dest, fwd))
            return
        if route.outcome in (Outcome.OFFLOAD_EXCEEDED, Outcome.INSUFFICIENT):
            self.meter.drop(req, now)
            return
        # local-ish execution
        self._execute_local(req, sid, now, push)

    def _execute_local(self, req: Request, sid: int, now: float,
                       push) -> None:
        svc = self.services[req.service]
        plan = self.scheduler.plans[req.service]
        st = self.state[sid]
        cap = st.capacity.get(req.service, 0.0)
        if cap <= 0:
            self.meter.drop(req, now)
            return
        if svc.is_frequency and req.duration_s > 0:
            demand_fps = req.frames / req.duration_s
            idle = max(0.0, cap - st.stream_load.get(req.service, 0.0))
            achievable = min(demand_fps, idle,
                             self.scheduler.stream_fps_cap(svc))
            if self.scheduler.request_level and achievable < demand_fps:
                # EPARA request-level DP: split surplus frames across peers
                achievable += self._peer_stream_share(
                    req, sid, demand_fps - achievable)
                achievable = min(achievable, demand_fps)
            st.stream_load[req.service] = \
                st.stream_load.get(req.service, 0.0) + achievable
            push(now + req.duration_s, "stream_end",
                 (req, achievable, sid))
        elif self.cfg.serving_mode == "sync":
            # run-to-completion barrier: the request waits for a full batch
            # (or the flush timer), then holds its slot for the whole batch
            forming = st.forming.setdefault(req.service, [])
            forming.append(req)
            gen = st.forming_gen.setdefault(req.service, 0)
            if len(forming) >= plan.bs:
                self._dispatch_batch(sid, req.service, now, push)
            elif len(forming) == 1:
                push(now + self.cfg.sync_flush_s, "batch_flush",
                     (sid, req.service, gen))
        else:
            # paged/continuous admission: the slot loop admits as capacity
            # frees, so latency service behaves as a 1/c fluid flow per
            # request.  The dense ("continuous") impl additionally pays
            # ``admission_copy_s`` per admission — the whole-live-batch
            # kvcache.merge copy and decode retrace the paged arena
            # eliminates (its admissions only scatter the new pages).
            eff_cap = max(1e-6, cap - st.stream_load.get(req.service, 0.0))
            vf0 = max(now, st.vf.get(req.service, now))
            own = 1.0 / eff_cap
            if self.cfg.serving_mode == "continuous":
                own += self.cfg.admission_copy_s
            # chunked-prefill model: the prompt's prefill is serial work.
            # Unchunked it lands on the SHARED virtual queue in one piece
            # (head-of-line blocking: every later finish waits); chunked,
            # only one chunk's worth stalls the queue — the rest
            # interleaves with decode, so only this request's own finish
            # pays for it.
            prefill_s = req.prompt_tokens * self.cfg.prefill_token_s
            # the discount mirrors the live gate exactly: paged data plane
            # + chunked prefill + token-pure family + plan knob on —
            # configurations where the real engine cannot reuse must not
            # be priced as if they could
            hit_rate = self.cfg.prefix_hit_rate
            if self.cfg.prefix_hit_rates is not None:
                hit_rate = self.cfg.prefix_hit_rates.get(req.service,
                                                         hit_rate)
            if (hit_rate > 0 and prefill_s > 0
                    and self.cfg.serving_mode == "paged"
                    and self.cfg.prefill_chunk_tokens > 0
                    and svc.prefix_cacheable
                    and getattr(plan, "prefix_cache", 0) != 0):
                # hit-rate-aware prefill: cached prefix tokens skip
                # compute, so the shared queue (and with it goodput /
                # placement quality) sees the post-reuse cost
                saved = prefill_s * hit_rate
                prefill_s -= saved
                self._cached_prefill_s += saved
            stall = prefill_s
            if prefill_s > 0:
                chunk = self.cfg.prefill_chunk_tokens
                if chunk > 0:
                    stall = (min(req.prompt_tokens, chunk)
                             * self.cfg.prefill_token_s)
                self._max_prefill_stall = max(self._max_prefill_stall,
                                              stall)
            own += stall
            base = cm.effective_latency(svc, self.servers[0].gpu,
                                        batch=plan.bs, mp=plan.mp,
                                        mt=plan.mt, mf=plan.mf) / plan.bs
            # speculative-decoding discount: mirror the live gate (paged
            # plane, token-pure family, plan knob speculating) and scale
            # the decode term by the acceptance-rate-discounted launch
            # count — k accepted drafts ride each verify, bought with
            # (k+1) draft steps at spec_draft_cost each
            k_spec = (plan.resolved_speculate(True)
                      if hasattr(plan, "resolved_speculate") else 0)
            if (k_spec > 0 and self.cfg.serving_mode == "paged"
                    and svc.prefix_cacheable
                    and (self.cfg.spec_accept_rate > 0
                         or self.cfg.spec_draft_cost > 0)):
                base *= ((1.0 + self.cfg.spec_draft_cost * (k_spec + 1))
                         / (1.0 + self.cfg.spec_accept_rate * k_spec))
                self._spec_discounted += 1
            tail = prefill_s - stall   # non-stalling chunks: own cost only
            if self.cfg.admission_policy == "sdf" and req.deadline_s:
                # slack-ordered admission (live engine's AdmissionController
                # mirrored in fluid-flow terms): slack = deadline budget
                # minus this request's OWN unavoidable service time
                slack = req.deadline_s - now - (own + base + tail)
                if slack < 0:
                    # cannot finish even served immediately — shed before
                    # any capacity is spent (FIFO would serve it dead)
                    self._note_verdict(Outcome.DEADLINE_MISSED)
                    self.meter.drop(req, now)
                    return
                if vf0 - now > slack:
                    # queue wait alone would burn the slack: preempt by
                    # block-table parking — jump the virtual queue at the
                    # park/resume overhead, while the displaced decode
                    # work still occupies the server (vf advances by the
                    # full own-service time, conserving capacity)
                    self._preemptions += 1
                    self._note_verdict(Outcome.ADMIT)
                    st.vf[req.service] = vf0 + own
                    finish = (now + own + base + tail
                              + self.cfg.preempt_overhead_s)
                    push(finish, "done", (req, finish, sid, now))
                    return
                self._note_verdict(Outcome.ADMIT)
            vf = vf0 + own
            st.vf[req.service] = vf
            finish = vf + base + tail
            push(finish, "done", (req, finish, sid, now))

    def _dispatch_batch(self, sid: int, service: str, now: float,
                        push) -> None:
        """Sync mode: run one composed batch to completion; every member
        finishes together at the batch-wide latency (the barrier cost the
        continuous engine removes)."""
        st = self.state[sid]
        batch = st.forming.pop(service, [])
        st.forming_gen[service] = st.forming_gen.get(service, 0) + 1
        if not batch:
            return
        svc = self.services[service]
        plan = self.scheduler.plans[service]
        # a flush-timer partial batch only pays for its own size; the sync
        # cost is the barrier wait + whole-batch hold, not padded compute
        batch_lat = cm.effective_latency(svc, self.servers[0].gpu,
                                         batch=len(batch), mp=plan.mp,
                                         mt=plan.mt, mf=plan.mf)
        vf = max(now, st.vf.get(service, now)) + batch_lat
        st.vf[service] = vf
        for req in batch:
            push(vf, "done", (req, vf, sid, now))

    def _peer_stream_share(self, req: Request, sid: int,
                           needed_fps: float) -> float:
        """Round-robin the stream's surplus frames across peers with idle
        capacity (request-level DP across servers)."""
        got = 0.0
        for s in self.server_ids:
            if s == sid or needed_fps - got <= 1e-9:
                continue
            st = self.state[s]
            idle = max(0.0, st.capacity.get(req.service, 0.0)
                       - st.stream_load.get(req.service, 0.0))
            take = min(idle, needed_fps - got) * 0.9  # offload discount
            if take > 0:
                st.stream_load[req.service] = \
                    st.stream_load.get(req.service, 0.0) + take
                got += take
                # release happens with the stream (approximate: schedule on
                # the home server's stream_end; peers release via decay)
                self._schedule_peer_release(req, s, take)
        return got

    def _schedule_peer_release(self, req: Request, sid: int,
                               fps: float) -> None:
        heapq.heappush(self._heap, (
            req.arrival_s + req.duration_s, next(self._seq), "stream_end",
            (dataclasses.replace(req, frames=0), fps, sid)))


def run_comparison(servers, services, events, scheduler_names,
                   cfg: SimConfig = SimConfig(), *, seed: int = 0
                   ) -> Dict[str, SimResult]:
    from .baselines import make_scheduler
    gpu = servers[0].gpu
    out = {}
    for name in scheduler_names:
        sched = make_scheduler(name, services, gpu, seed=seed)
        sim = Simulation(servers, services, sched, events, cfg)
        out[name] = sim.run()
    return out
