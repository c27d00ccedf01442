"""State-aware submodular service placement — SSSP (§3.3, Alg. 1 + 2).

A *placement* x_{ln} deploys service l's full ParallelPlan on server n.
φ(Θ) (Eq. 2) counts requests satisfied over the period T under the §3.2
handling strategy; we evaluate it with a deterministic fluid model of that
strategy (local-first, then offload spillover), which is monotone and
submodular in the placement set — property-tested in
tests/test_placement.py and the basis of the 1/(1+P) bound (Appendix A).

Algorithm 1 (SSSP) runs three SPF stages:
  S1 — priority list X̄ (leased GPUs / parallel-intensive services first),
       list semantics, continues on φ-equal steps;
  S2 — all (service, server) pairs, set semantics, strict improvement;
  S3 — the hypothetical aggregated server ε (cross-server parallelism).

Algorithm 2 (SPF) is greedy submodular maximization; ``lazy=True`` uses
CELF lazy evaluation (valid by submodularity) — the beyond-paper speedup
that keeps single-placement latency <200 ms at large N (Fig. 17c).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from . import costmodel as cm
from .allocator import ParallelPlan, plan_goodput
from .categories import GPUSpec, ServerSpec, ServiceSpec

EPSILON_SERVER = -1   # the hypothetical aggregated server ε (S3)

Placement = Tuple[str, int]          # (service, server-id | EPSILON_SERVER)


@dataclasses.dataclass
class PlacementProblem:
    services: Dict[str, ServiceSpec]
    plans: Dict[str, ParallelPlan]
    servers: List[ServerSpec]
    demand: Dict[Tuple[str, int], float]     # reqs/s arriving at server n
    period_s: float = 60.0
    priority_list: Sequence[Placement] = ()  # X̄ for S1
    offload_efficiency: float = 0.9          # handler spillover discount

    def server_by_id(self) -> Dict[int, ServerSpec]:
        return {s.sid: s for s in self.servers}

    # resource footprint of one placement (the two matroid dimensions)
    def compute_units(self, svc: str) -> float:
        plan = self.plans[svc]
        return plan.gpus / max(1, plan.mt)

    def vram_units(self, svc: str) -> float:
        plan = self.plans[svc]
        spec = self.services[svc]
        gpu = self.servers[0].gpu if self.servers else GPUSpec()
        return cm.vram_fraction(spec, gpu, plan.mp) * plan.gpus


# ---------------------------------------------------------------------------
# feasibility (matroid independence)
# ---------------------------------------------------------------------------

def _budgets(problem: PlacementProblem,
             placements: Iterable[Placement]) -> Dict[int, Tuple[float, float]]:
    """Remaining (compute, vram) units per server under ``placements``."""
    rem = {s.sid: (float(s.num_gpus), float(s.num_gpus))
           for s in problem.servers}
    eps_compute = 0.0
    for svc, sid in placements:
        if sid == EPSILON_SERVER:
            eps_compute += problem.compute_units(svc)
            continue
        c, v = rem[sid]
        rem[sid] = (c - problem.compute_units(svc),
                    v - problem.vram_units(svc))
    # ε's budget = pooled leftovers
    pooled = sum(max(0.0, c) for c, _ in rem.values())
    rem[EPSILON_SERVER] = (pooled - eps_compute, pooled - eps_compute)
    return rem


def feasible(problem: PlacementProblem, placements: Sequence[Placement],
             candidate: Placement) -> bool:
    if candidate in placements:
        return False
    svc, sid = candidate
    rem = _budgets(problem, placements)
    c, v = rem[sid]
    if sid == EPSILON_SERVER:
        return problem.compute_units(svc) <= c + 1e-9
    return (problem.compute_units(svc) <= c + 1e-9
            and problem.vram_units(svc) <= v + 1e-9)


# ---------------------------------------------------------------------------
# φ — fluid evaluation of the §3.2 handling strategy (Eq. 2)
# ---------------------------------------------------------------------------

def evaluate(problem: PlacementProblem,
             placements: Sequence[Placement]) -> float:
    """Satisfied requests over the period under local-first + spillover."""
    if not problem.servers:
        return 0.0
    gpu = problem.servers[0].gpu
    cap: Dict[Tuple[str, int], float] = {}
    for svc, sid in placements:
        spec = problem.services[svc]
        plan = problem.plans[svc]
        g = plan_goodput(spec, gpu, plan,
                         cross_server=(sid == EPSILON_SERVER))
        cap[(svc, sid)] = cap.get((svc, sid), 0.0) + g

    total = 0.0
    for svc in problem.services:
        local_sat = 0.0
        leftover_demand = 0.0
        leftover_cap = cap.get((svc, EPSILON_SERVER), 0.0)
        for server in problem.servers:
            d = problem.demand.get((svc, server.sid), 0.0)
            c = cap.get((svc, server.sid), 0.0)
            s = min(d, c)
            local_sat += s
            leftover_demand += d - s
            leftover_cap += c - s
        # offloaded requests satisfy at a discount (transfer latency eats
        # into the SLO budget) — this is what makes local placement near
        # demand strictly better and the evaluator "state-aware".
        offload_sat = problem.offload_efficiency * min(leftover_demand,
                                                       leftover_cap)
        total += local_sat + offload_sat
    return total * problem.period_s


# ---------------------------------------------------------------------------
# incremental φ — O(1) marginal gains (same math as ``evaluate``; equality
# is property-tested).  This is what keeps one SSSP round <200 ms at large
# N (Fig. 17c): the greedy needs |candidates| gain queries per selection.
# ---------------------------------------------------------------------------

class PhiState:
    def __init__(self, problem: PlacementProblem,
                 theta0: Sequence[Placement] = ()):
        self.p = problem
        gpu = problem.servers[0].gpu if problem.servers else GPUSpec()
        self._g = {svc: plan_goodput(problem.services[svc], gpu,
                                     problem.plans[svc])
                   for svc in problem.services}
        self._g_eps = {svc: plan_goodput(problem.services[svc], gpu,
                                         problem.plans[svc],
                                         cross_server=True)
                       for svc in problem.services}
        self.cap: Dict[Placement, float] = {}
        self.local_sat: Dict[str, float] = {s: 0.0 for s in problem.services}
        self.total_cap: Dict[str, float] = {s: 0.0 for s in problem.services}
        self.eps_cap: Dict[str, float] = {s: 0.0 for s in problem.services}
        self.total_demand: Dict[str, float] = {s: 0.0
                                               for s in problem.services}
        for (svc, sid), d in problem.demand.items():
            if svc in self.total_demand:
                self.total_demand[svc] += d
        # feasibility budgets, maintained incrementally
        self.rem: Dict[int, List[float]] = {
            s.sid: [float(s.num_gpus), float(s.num_gpus)]
            for s in problem.servers}
        self.placed: set = set()
        for delta in theta0:
            self.add(delta)

    # -- φ ----------------------------------------------------------------
    def _svc_phi(self, svc: str, local_sat: float, total_cap: float,
                 eps_cap: float) -> float:
        lo_d = self.total_demand[svc] - local_sat
        lo_c = (total_cap - local_sat) + eps_cap
        return local_sat + self.p.offload_efficiency * min(lo_d, lo_c)

    def total(self) -> float:
        out = 0.0
        for svc in self.p.services:
            out += self._svc_phi(svc, self.local_sat[svc],
                                 self.total_cap[svc], self.eps_cap[svc])
        return out * self.p.period_s

    def gain(self, delta: Placement) -> float:
        svc, sid = delta
        before = self._svc_phi(svc, self.local_sat[svc],
                               self.total_cap[svc], self.eps_cap[svc])
        if sid == EPSILON_SERVER:
            after = self._svc_phi(svc, self.local_sat[svc],
                                  self.total_cap[svc],
                                  self.eps_cap[svc] + self._g_eps[svc])
        else:
            g = self._g[svc]
            d = self.p.demand.get((svc, sid), 0.0)
            old_c = self.cap.get(delta, 0.0)
            dl = min(d, old_c + g) - min(d, old_c)
            after = self._svc_phi(svc, self.local_sat[svc] + dl,
                                  self.total_cap[svc] + g,
                                  self.eps_cap[svc])
        return (after - before) * self.p.period_s

    def add(self, delta: Placement) -> None:
        svc, sid = delta
        if sid == EPSILON_SERVER:
            self.eps_cap[svc] += self._g_eps[svc]
            # ε consumes pooled leftovers: charge the least-loaded servers
            need = self.p.compute_units(svc)
            for sid2 in sorted(self.rem, key=lambda s: -self.rem[s][0]):
                take = min(need, max(0.0, self.rem[sid2][0]))
                self.rem[sid2][0] -= take
                need -= take
                if need <= 1e-9:
                    break
        else:
            g = self._g[svc]
            d = self.p.demand.get((svc, sid), 0.0)
            old_c = self.cap.get(delta, 0.0)
            self.local_sat[svc] += min(d, old_c + g) - min(d, old_c)
            self.total_cap[svc] += g
            self.cap[delta] = old_c + g
            self.rem[sid][0] -= self.p.compute_units(svc)
            self.rem[sid][1] -= self.p.vram_units(svc)
        self.placed.add(delta)

    def feasible(self, delta: Placement) -> bool:
        if delta in self.placed:
            return False
        svc, sid = delta
        if sid == EPSILON_SERVER:
            pooled = sum(max(0.0, c) for c, _ in self.rem.values())
            return self.p.compute_units(svc) <= pooled + 1e-9
        c, v = self.rem[sid]
        return (self.p.compute_units(svc) <= c + 1e-9
                and self.p.vram_units(svc) <= v + 1e-9)


# ---------------------------------------------------------------------------
# Algorithm 2 — submodular placement for full models (SPF)
# ---------------------------------------------------------------------------

def spf(problem: PlacementProblem, candidates: Sequence[Placement],
        theta0: Sequence[Placement], *, list_semantics: bool = False,
        allow_equal: bool = False, lazy: bool = True) -> List[Placement]:
    """Greedy: repeatedly add the feasible candidate with the largest
    marginal gain; stop when gain is non-positive (S1: negative).  All gain
    queries go through the O(1) incremental PhiState (identical to
    ``evaluate`` — property-tested)."""
    theta = list(theta0)
    state = PhiState(problem, theta0)

    if lazy and not list_semantics:
        return _spf_lazy(problem, candidates, theta, state,
                         allow_equal=allow_equal)

    remaining = list(candidates)
    while True:
        best_gain, best = -math.inf, None
        for delta in remaining:
            if list_semantics and delta in theta:
                continue
            if not state.feasible(delta):
                continue
            gain = state.gain(delta)
            if gain > best_gain:
                best_gain, best = gain, delta
        if best is None:
            break
        if best_gain < 0 or (best_gain == 0 and not allow_equal):
            break
        theta.append(best)
        state.add(best)
        if list_semantics:
            remaining = [c for c in remaining if c != best]
        if best_gain == 0 and allow_equal:
            # φ-equal steps may continue under S1 (>=) but a full sweep of
            # zero gains cannot improve further — stop after one pass.
            allow_equal = False
    return theta


def _spf_lazy(problem: PlacementProblem, candidates: Sequence[Placement],
              theta: List[Placement], state: "PhiState", *,
              allow_equal: bool) -> List[Placement]:
    """CELF lazy greedy — marginal gains only shrink (submodularity), so a
    stale upper bound at the heap top that is still the max after refresh
    is the true argmax."""
    heap: List[Tuple[float, int, Placement]] = []
    for i, delta in enumerate(candidates):
        heap.append((-state.gain(delta), i, delta))
    heapq.heapify(heap)
    while heap:
        neg_gain, order, delta = heapq.heappop(heap)
        if -neg_gain <= 0 and not (allow_equal and -neg_gain == 0):
            break
        if delta in theta or not state.feasible(delta):
            continue
        fresh = state.gain(delta)
        if heap and fresh < -heap[0][0] - 1e-12:
            # keep the candidate's original index as the tiebreak: the old
            # id(delta) key made equal-gain pops follow allocation
            # addresses, so placements (and every downstream goodput
            # figure) varied run to run
            heapq.heappush(heap, (-fresh, order, delta))
            continue
        if fresh <= 0 and not (allow_equal and fresh == 0):
            break
        theta.append(delta)
        state.add(delta)
    return theta


# ---------------------------------------------------------------------------
# Algorithm 1 — state-aware service placement (SSSP)
# ---------------------------------------------------------------------------

def sssp(problem: PlacementProblem, *, lazy: bool = True,
         include_epsilon: bool = True) -> List[Placement]:
    theta: List[Placement] = []
    # S1: priority list X̄ (list semantics, >= continuation)
    if problem.priority_list:
        theta = spf(problem, list(problem.priority_list), theta,
                    list_semantics=True, allow_equal=True, lazy=False)
    # S2: all (service, server) pairs
    all_pairs = [(svc, s.sid) for svc in problem.services
                 for s in problem.servers]
    theta = spf(problem, all_pairs, theta, lazy=lazy)
    # S3: hypothetical aggregated server ε for cross-server parallelism
    if include_epsilon:
        eps_pairs = [(svc, EPSILON_SERVER) for svc, spec
                     in problem.services.items()
                     if problem.plans[svc].mp > 1]
        theta = spf(problem, eps_pairs, theta, lazy=lazy)
    return theta


# ---------------------------------------------------------------------------
# approximation bound (Eq. 3 / Appendix A)
# ---------------------------------------------------------------------------

def matroid_count(problem: PlacementProblem) -> int:
    """P = ceil(max a / min a>0) + ceil(max b / min b>0)."""
    a = [problem.compute_units(svc) for svc in problem.services]
    b = [problem.vram_units(svc) for svc in problem.services]
    a_pos = [x for x in a if x > 0]
    b_pos = [x for x in b if x > 0]
    pa = math.ceil(max(a) / min(a_pos)) if a_pos else 0
    pb = math.ceil(max(b) / min(b_pos)) if b_pos else 0
    return pa + pb


def approximation_bound(problem: PlacementProblem) -> float:
    """The guaranteed fraction of optimum: 1 / (1 + P)."""
    return 1.0 / (1.0 + matroid_count(problem))


# ---------------------------------------------------------------------------
# online placement (§3.3): large-scale deployments allocate compute/VRAM
# per-GPU as services arrive, "optimized greedy" in the OpenStack style the
# paper cites [51] — best-fit-decreasing on the bottleneck resource.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OnlinePlacer:
    """Incremental placement: services arrive one at a time (no full R^T);
    each is placed on the feasible server with the highest residual-demand
    match, best-fit on the scarcer of (compute, VRAM).  Used when server
    counts make periodic full SSSP too coarse (§3.3 'online')."""
    problem: PlacementProblem

    def __post_init__(self):
        self.state = PhiState(self.problem)
        self.placed: List[Placement] = []

    def offer(self, svc: str) -> Optional[Placement]:
        """Place one arriving service; returns the placement or None."""
        best, best_score = None, -math.inf
        cu = self.problem.compute_units(svc)
        vu = self.problem.vram_units(svc)
        for server in self.problem.servers:
            cand = (svc, server.sid)
            if not self.state.feasible(cand):
                continue
            gain = self.state.gain(cand)
            c, v = self.state.rem[server.sid]
            # best fit: prefer high phi-gain, tie-break on tightest
            # residual of the bottleneck resource (packs better online)
            slack = min(c - cu, v - vu)
            score = gain - 1e-6 * slack
            if score > best_score:
                best, best_score = cand, score
        if best is None:
            return None
        self.state.add(best)
        self.placed.append(best)
        return best

    def phi(self) -> float:
        return self.state.total()


def online_placement(problem: PlacementProblem,
                     arrival_order: Sequence[str]) -> List[Placement]:
    placer = OnlinePlacer(problem)
    for svc in arrival_order:
        placer.offer(svc)
    return placer.placed


# ---------------------------------------------------------------------------
# cache-policy baselines for Fig. 17b
# ---------------------------------------------------------------------------

def _fill_by_order(problem: PlacementProblem,
                   order: Sequence[str]) -> List[Placement]:
    theta: List[Placement] = []
    for server in problem.servers:
        for svc in order:
            cand = (svc, server.sid)
            if feasible(problem, theta, cand):
                theta.append(cand)
    return theta


def place_lru(problem: PlacementProblem,
              last_used: Mapping[str, float]) -> List[Placement]:
    order = sorted(problem.services, key=lambda s: -last_used.get(s, 0.0))
    return _fill_by_order(problem, order)


def place_lfu(problem: PlacementProblem,
              use_count: Mapping[str, float]) -> List[Placement]:
    order = sorted(problem.services, key=lambda s: -use_count.get(s, 0.0))
    return _fill_by_order(problem, order)


def place_mfu(problem: PlacementProblem,
              use_count: Mapping[str, float]) -> List[Placement]:
    """MFU evicts the most-frequently used -> places least-used first."""
    order = sorted(problem.services, key=lambda s: use_count.get(s, 0.0))
    return _fill_by_order(problem, order)
