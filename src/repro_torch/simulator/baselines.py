"""Scheduler strategies: EPARA + the paper's comparison systems.

Each scheduler fixes (a) the operator policy (which of BS/MT/MP/MF/DP it
may use — Table 3's "Allocation Level"), (b) the placement policy, (c) the
routing policy, and (d) its per-decision scheduling latency.  The event
engine is strategy-agnostic.

  InterEdge   [4]  — decentralized, universal tasks: no request-level ops,
                     round-robin forwarding, MP/BS/MT aligned with EPARA.
  AlpaServe   [43] — datacenter: MP+BS centralized with perfect state; no
                     multi-server offload chains; refuses cross-server MP.
  Galaxy      [80] — centralized edge devices MP; no batching, no MT.
  SERV-P      [19] — centralized NP-hard placement+handling; scheduling
                     latency grows superlinearly with servers (Fig. 3e).
  USHER       [65] — interference-aware MP+BS+MT, centralized, no
                     request-level.
  DeTransformer [73] — communication-efficient cross-server MP, no MT/MF/DP.
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core import costmodel as cm
from repro_torch.core.allocator import ParallelPlan, allocate, plan_goodput
from repro_torch.core.categories import (GPUSpec, Request, ServerSpec, ServiceSpec,
                                   TaskCategory)
from repro_torch.core.goodput import deadline_expired
from repro_torch.core.handler import Outcome
from repro_torch.core.placement import (EPSILON_SERVER, PlacementProblem, evaluate,
                                  sssp)


@dataclasses.dataclass(frozen=True)
class Route:
    outcome: Outcome
    destination: Optional[int] = None


class Scheduler:
    """Base class; subclasses override policy knobs."""
    name = "base"
    request_level = False          # DP + MF available?
    centralized = False
    allows_cross_server_mp = True
    allows_offload = True

    def __init__(self, services: Mapping[str, ServiceSpec],
                 gpu: GPUSpec, *, seed: int = 0):
        self.services = dict(services)
        self.gpu = gpu
        self.rng = random.Random(seed)
        self.plans = {n: self.plan_for(s) for n, s in self.services.items()}

    # -- operator policy ---------------------------------------------------
    def plan_for(self, svc: ServiceSpec) -> ParallelPlan:
        plan = allocate(svc, self.gpu)
        if not self.request_level:
            plan = dataclasses.replace(plan, dp=1, mf=1)
        return plan

    # -- placement policy -----------------------------------------------------
    def place(self, problem: PlacementProblem) -> List[Tuple[str, int]]:
        problem = dataclasses.replace(problem, plans=self.plans)
        return sssp(problem,
                    include_epsilon=self.allows_cross_server_mp)

    # -- routing policy ---------------------------------------------------------
    def scheduling_latency(self, num_servers: int) -> float:
        return 0.0005  # decentralized constant

    def stream_fps_cap(self, svc: ServiceSpec) -> float:
        """Max fps ONE stream can reach.  Without request-level DP a stream
        is unsplittable: capped at a single replica group's throughput."""
        plan = self.plans[svc.name]
        per_group = cm.throughput(svc, self.gpu, batch=plan.bs, mp=plan.mp,
                                  mt=plan.mt)
        if self.request_level:
            return per_group * max(1, plan.dp) * max(1, plan.mt)
        return per_group

    def route(self, req: Request, sid: int, now: float, ctx) -> Route:
        raise NotImplementedError


class EparaScheduler(Scheduler):
    name = "EPARA"
    request_level = True

    def route(self, req, sid, now, ctx) -> Route:
        decision = ctx.control_plane.handle(req, now, at_server=sid)
        return Route(decision.outcome, decision.destination)


class InterEdgeScheduler(Scheduler):
    name = "InterEdge"
    request_level = False

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._rr = itertools.count()

    def place(self, problem):
        # spread every service round-robin until resources run out
        theta: List[Tuple[str, int]] = []
        from repro_torch.core.placement import feasible
        problem = dataclasses.replace(problem, plans=self.plans)
        for svc in problem.services:
            for server in problem.servers:
                cand = (svc, server.sid)
                if feasible(problem, theta, cand):
                    theta.append(cand)
        return theta

    def route(self, req, sid, now, ctx) -> Route:
        if deadline_expired(req.deadline_s, now):
            return Route(Outcome.TIMEOUT)
        if ctx.has_capacity(sid, req.service, now):
            return Route(Outcome.LOCAL)
        if req.offload_count >= 5:
            return Route(Outcome.OFFLOAD_EXCEEDED)
        # state-blind round-robin forwarding
        peers = [s for s in ctx.server_ids if s != sid
                 and not req.on_path(s)]
        if not peers:
            return Route(Outcome.INSUFFICIENT)
        dest = peers[next(self._rr) % len(peers)]
        return Route(Outcome.OFFLOAD, dest)


class AlpaServeScheduler(Scheduler):
    name = "AlpaServe"
    request_level = False
    centralized = True
    allows_cross_server_mp = False   # refuses multi-server parallelism
    allows_offload = False

    def route(self, req, sid, now, ctx) -> Route:
        if deadline_expired(req.deadline_s, now):
            return Route(Outcome.TIMEOUT)
        # centralized dispatch with PERFECT state: least-loaded host
        best, best_load = None, float("inf")
        for s in ctx.server_ids:
            if not ctx.is_placed(s, req.service):
                continue
            load = ctx.queue_time(s, req.service, now)
            if load < best_load:
                best, best_load = s, load
        if best is None:
            return Route(Outcome.INSUFFICIENT)
        if best == sid:
            return Route(Outcome.LOCAL)
        return Route(Outcome.OFFLOAD, best)


class GalaxyScheduler(Scheduler):
    name = "Galaxy"
    request_level = False
    centralized = True

    def plan_for(self, svc):
        plan = allocate(svc, self.gpu)
        # no batching, no multi-task ([80] lacks both)
        return dataclasses.replace(plan, bs=1, mt=1, dp=1, mf=1)

    def route(self, req, sid, now, ctx) -> Route:
        if deadline_expired(req.deadline_s, now):
            return Route(Outcome.TIMEOUT)
        for s in ctx.server_ids:
            if ctx.is_placed(s, req.service) and \
                    ctx.has_capacity(s, req.service, now):
                return Route(Outcome.LOCAL if s == sid
                             else Outcome.OFFLOAD, None if s == sid else s)
        return Route(Outcome.INSUFFICIENT)


class ServPScheduler(Scheduler):
    name = "SERV-P"
    request_level = False
    centralized = True

    def plan_for(self, svc):
        plan = allocate(svc, self.gpu)
        # universal-task system: no AI-aware batching / MT
        return dataclasses.replace(plan, bs=1, mt=1, dp=1, mf=1)

    def scheduling_latency(self, num_servers: int) -> float:
        """Fig. 3e: ~100 ms at 10 servers, >750 ms at 30+ (groups of 10
        used in §5.2 to stay feasible)."""
        n = min(num_servers, 10)   # grouped scheduling
        return 1.0e-3 * n ** 2

    def route(self, req, sid, now, ctx) -> Route:
        if deadline_expired(req.deadline_s, now):
            return Route(Outcome.TIMEOUT)
        group = [s for s in ctx.server_ids if s // 10 == sid // 10]
        best, best_load = None, float("inf")
        for s in group:
            if ctx.is_placed(s, req.service):
                load = ctx.queue_time(s, req.service, now)
                if load < best_load:
                    best, best_load = s, load
        if best is None:
            return Route(Outcome.INSUFFICIENT)
        return Route(Outcome.LOCAL if best == sid else Outcome.OFFLOAD,
                     None if best == sid else best)


class UsherScheduler(Scheduler):
    name = "USHER"
    request_level = False
    centralized = True

    def route(self, req, sid, now, ctx) -> Route:
        if deadline_expired(req.deadline_s, now):
            return Route(Outcome.TIMEOUT)
        best, best_load = None, float("inf")
        for s in ctx.server_ids:
            if ctx.is_placed(s, req.service):
                load = ctx.queue_time(s, req.service, now)
                if load < best_load:
                    best, best_load = s, load
        if best is None:
            return Route(Outcome.INSUFFICIENT)
        return Route(Outcome.LOCAL if best == sid else Outcome.OFFLOAD,
                     None if best == sid else best)


class DeTransformerScheduler(GalaxyScheduler):
    name = "DeTransformer"

    def plan_for(self, svc):
        plan = allocate(svc, self.gpu)
        # block-parallel design keeps BS but no MT / request-level
        return dataclasses.replace(plan, mt=1, dp=1, mf=1)


SCHEDULERS = {
    "EPARA": EparaScheduler,
    "InterEdge": InterEdgeScheduler,
    "AlpaServe": AlpaServeScheduler,
    "Galaxy": GalaxyScheduler,
    "SERV-P": ServPScheduler,
    "USHER": UsherScheduler,
    "DeTransformer": DeTransformerScheduler,
}


def make_scheduler(name: str, services, gpu, *, seed: int = 0) -> Scheduler:
    return SCHEDULERS[name](services, gpu, seed=seed)
