"""Task-categorized parallelism allocator (§3.1) + adaptive deployment
(§4.1).

Given a service, its SLOs, and the hardware, the allocator decides a
``ParallelPlan`` (MP, BS, MT, MF, DP) by the paper's rules:

* categorize by (latency|frequency) x (<=1 | >1 GPU);
* MP: user-specified or smallest power-of-two whose pooled VRAM fits and
  whose latency meets the SLO (the "DeepSpeed-prescribed" default);
* BS: offline profiling over 2^0..2^9 — largest batch whose latency stays
  within SLO (max throughput under the latency constraint);
* MT: offline profiling over 2^0..2^4 — replication degree bounded by VRAM;
* MF (Eq. 5): inter-frame count bounded by the per-frame latency budget;
  inter_request_count = floor(BS / MF);
* DP (Eq. 4): group count = ceil(fps_requirement / fps_of_one_group).

``mesh_submesh`` maps a plan onto the TPU mesh: DP groups tile the ``data``
axis, MP tiles the ``model`` axis — this is how the paper's technique
becomes a first-class scheduling input for the JAX launcher.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from . import costmodel as cm
from .categories import (CAT_FREQ_MULTI, CAT_FREQ_SINGLE, CAT_LAT_MULTI,
                         CAT_LAT_SINGLE, KV_DTYPE_BY_SENSITIVITY,
                         PARALLEL_SAMPLES_BY_SENSITIVITY,
                         PREFIX_RETENTION_FRACTION,
                         SPECULATE_BY_SENSITIVITY, GPUSpec, Operator,
                         Sensitivity, ServiceSpec, TaskCategory,
                         operators_for)

BS_CANDIDATES = tuple(2 ** i for i in range(10))     # 2^0 .. 2^9  (§4.1)
MT_CANDIDATES = tuple(2 ** i for i in range(5))      # 2^0 .. 2^4  (§4.1)
MAX_MP = 64


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """The allocator's full decision for one service."""
    service: str
    category: TaskCategory
    mp: int = 1          # model-parallel degree (GPUs per replica group)
    bs: int = 1          # batch size
    mt: int = 1          # co-located replication degree on each GPU
    mf: int = 1          # inter-frame count (frequency tasks)
    dp: int = 1          # replica group count (frequency tasks)
    sticky: bool = False  # session-sticky DP routing (stateful archs)
    prefill_chunk: int = 0  # chunked-prefill bucket size in tokens
    #                         (0 = derive from the task category)
    prefix_cache: int = -1  # shared-prefix KV retention knob: -1 = derive
    #                         from the task category (frequency retains
    #                         aggressively, latency bounded), 0 = disabled,
    #                         >0 = max idle cached blocks retained
    kv_dtype: object = -1   # paged-KV precision: -1 = derive from the task
    #                         category (frequency -> "int8", latency ->
    #                         "bf16"), or an explicit "bf16"/"int8" override
    #                         ("bf16" = keep the model's native KV dtype)
    admission: str = "fifo"  # request-admission policy for the serving
    #                          engine: "fifo" = legacy arrival order (never
    #                          sheds; doomed requests rot in queue), "sdf"
    #                          = StrictestDeadlineFirst — order pending
    #                          admissions by deadline slack, shed with
    #                          explicit verdicts (DEADLINE_MISSED /
    #                          CONGESTION / OFFLOAD) and preempt live
    #                          slots by block-table parking under pressure
    speculate: int = -1     # speculative-decoding draft length k: -1 =
    #                         derive from the task category (latency -> k=4
    #                         when a draft model is configured, frequency
    #                         -> 0), 0 = disabled, >0 = explicit k (the
    #                         engine then REQUIRES a draft model)
    n_samples: int = -1     # per-request parallel-sampling cap: -1 =
    #                         derive from the task category (frequency ->
    #                         uncapped up to bs, latency -> 1), 0 =
    #                         uncapped (bs-bounded), >0 = explicit cap on
    #                         a request's n_samples fan-out

    def __post_init__(self):
        for field in ("mp", "bs", "mt", "mf", "dp"):
            v = getattr(self, field)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                raise ValueError(
                    f"ParallelPlan.{field} must be a positive int, got "
                    f"{v!r}")
        pc = self.prefill_chunk
        if not isinstance(pc, int) or isinstance(pc, bool) or pc < 0:
            raise ValueError(
                f"ParallelPlan.prefill_chunk must be 0 (category default) "
                f"or a positive token count, got {pc!r}; the serving "
                f"engine additionally requires a multiple of its block "
                f"size")
        px = self.prefix_cache
        if not isinstance(px, int) or isinstance(px, bool) or px < -1:
            raise ValueError(
                f"ParallelPlan.prefix_cache must be -1 (category default), "
                f"0 (disabled) or a positive retention block count, got "
                f"{px!r}")
        kd = self.kv_dtype
        if kd != -1 and kd not in KV_DTYPE_BY_SENSITIVITY.values():
            valid = sorted(set(KV_DTYPE_BY_SENSITIVITY.values()))
            raise ValueError(
                f"ParallelPlan.kv_dtype must be -1 (category default) or "
                f"one of {valid}, got {kd!r}")
        sp = self.speculate
        if not isinstance(sp, int) or isinstance(sp, bool) or sp < -1:
            raise ValueError(
                f"ParallelPlan.speculate must be -1 (category default), 0 "
                f"(disabled) or a positive draft length, got {sp!r}")
        ns = self.n_samples
        if not isinstance(ns, int) or isinstance(ns, bool) or ns < -1:
            raise ValueError(
                f"ParallelPlan.n_samples must be -1 (category default), 0 "
                f"(uncapped) or a positive per-request cap, got {ns!r}")

    @property
    def gpus(self) -> int:
        return self.mp * self.dp

    @property
    def inter_request_count(self) -> int:
        """Eq. 5: concurrent streams multiplexed into one batch."""
        return max(1, self.bs // max(1, self.mf))

    @property
    def max_in_flight(self) -> int:
        """Decode slots per replica runtime: the continuous-batching engine
        keeps at most ``bs`` requests in flight per DP group (the profiled
        batch is the largest the latency SLO tolerates, so it also bounds
        the fused decode batch)."""
        return self.bs

    @property
    def server_slots(self) -> int:
        """Total concurrent decode slots this plan sustains on a server:
        MT co-locates ``mt`` independent runtimes per group (each with its
        own ``bs`` slots) and DP adds ``dp`` replica groups."""
        return self.bs * self.mt * self.dp

    def prefill_chunk_tokens(self, block_size: int = 32) -> int:
        """Chunked-prefill bucket size for the serving engine's
        piggybacked prefill.  Latency-sensitive categories take SMALL
        chunks (prompt work is finely interleaved, so live decode slots
        see minimal added per-step latency); frequency/throughput
        categories take LARGE chunks (fewer, fatter prefill calls — per-
        step stall matters less than aggregate prefill throughput)."""
        if self.prefill_chunk > 0:
            return self.prefill_chunk
        mult = 2 if self.category.sensitivity == Sensitivity.LATENCY else 4
        return mult * block_size

    def prefix_cache_blocks(self, pool_blocks: int,
                            override: Optional[int] = None) -> int:
        """Idle-retention bound for the serving engine's radix prefix
        cache, in arena blocks.  0 disables; otherwise the task category
        decides how aggressively unreferenced-but-cached blocks are
        retained before LRU reclaim: frequency categories (periodic
        repeats of the same prompt prefix) keep the whole reclaimable
        pool, latency categories a bounded fraction."""
        knob = self.prefix_cache if override is None else override
        if knob == 0:
            return 0
        if knob > 0:
            return min(knob, pool_blocks)
        frac = PREFIX_RETENTION_FRACTION[self.category.sensitivity]
        return max(1, int(pool_blocks * frac))

    def resolved_kv_dtype(self) -> str:
        """Paged-KV pool precision for the serving engine's arena.  An
        explicit ``kv_dtype`` wins; -1 derives from the task category:
        frequency tasks (long KV-traffic-bound streams, drift-tolerant
        consumers) quantize blocks to int8 with per-token-per-head scales,
        latency tasks keep the model's native dtype."""
        if self.kv_dtype != -1:
            return self.kv_dtype
        return KV_DTYPE_BY_SENSITIVITY[self.category.sensitivity]

    def resolved_speculate(self, have_draft: bool = True) -> int:
        """Draft length k for speculative decoding.  An explicit
        ``speculate`` wins (and the serving engine rejects k>0 without a
        draft model); -1 derives from the task category — latency tasks
        buy per-request speed (k=4 when a draft model is available),
        frequency tasks buy batch and never speculate."""
        if self.speculate != -1:
            return self.speculate
        if not have_draft:
            return 0
        return SPECULATE_BY_SENSITIVITY[self.category.sensitivity]

    def resolved_n_samples(self) -> int:
        """Per-request parallel-sampling cap.  An explicit ``n_samples``
        wins; -1 derives from the task category — frequency tasks fork
        freely (capped only by ``bs``), latency tasks take the single
        fastest sample.  0 means uncapped (bs-bounded)."""
        if self.n_samples != -1:
            return self.n_samples
        cap = PARALLEL_SAMPLES_BY_SENSITIVITY[self.category.sensitivity]
        return cap if cap else self.bs

    def operators(self):
        ops = set()
        if self.bs > 1:
            ops.add(Operator.BS)
        if self.mt > 1:
            ops.add(Operator.MT)
        if self.mp > 1:
            ops.add(Operator.MP)
        if self.mf > 1:
            ops.add(Operator.MF)
        if self.dp > 1:
            ops.add(Operator.DP)
        return frozenset(ops)


def categorize(svc: ServiceSpec, gpu: GPUSpec, *,
               target_fps: Optional[float] = None) -> TaskCategory:
    """>1 GPU iff the model does not fit a single GPU's VRAM, or a single
    GPU cannot meet the latency SLO at batch 1."""
    multi = cm.min_mp_for_vram(svc, gpu) > 1
    if not multi:
        multi = cm.single_request_latency(svc, gpu) > svc.slo_latency_s
    return TaskCategory(svc.sensitivity, multi)


def _choose_mp(svc: ServiceSpec, gpu: GPUSpec,
               user_mp: Optional[int]) -> int:
    if user_mp is not None:
        return user_mp
    mp = cm.min_mp_for_vram(svc, gpu)
    # grow MP while latency SLO is violated and MP still helps
    while (cm.mp_latency(svc, gpu, mp) > svc.slo_latency_s and mp < MAX_MP):
        nxt = mp * 2
        if cm.mp_latency(svc, gpu, nxt) >= cm.mp_latency(svc, gpu, mp):
            break
        mp = nxt
    return mp


def _profile_bs(svc: ServiceSpec, gpu: GPUSpec, mp: int,
                user_bs: Optional[int]) -> int:
    """Offline profiling (§4.1): largest BS whose batch latency meets the
    latency budget; frequency tasks budget one SLO frame interval."""
    if user_bs is not None:
        return user_bs
    budget = svc.slo_latency_s
    if svc.is_frequency and svc.slo_fps > 0:
        budget = min(budget, max(1.0 / svc.slo_fps, budget * 0.5))
    best = 1
    for bs in BS_CANDIDATES:
        if cm.mp_latency(svc, gpu, mp, batch=bs) <= budget:
            best = bs
    return best


def _profile_mt(svc: ServiceSpec, gpu: GPUSpec, mp: int, bs: int) -> int:
    """Replication degree bounded by VRAM and by the latency budget under
    interference (§4.1's replication profiling)."""
    best = 1
    for mt in MT_CANDIDATES:
        if cm.vram_fraction(svc, gpu, mp) * mt > 1.0:
            break
        lat = cm.effective_latency(svc, gpu, batch=bs, mp=mp, mt=mt)
        if lat <= svc.slo_latency_s:
            best = mt
    return best


def _choose_mf(svc: ServiceSpec, bs: int) -> int:
    """Eq. 5 setup: MF = max inter-frame count tolerated by the per-frame
    latency requirement (grouping delays frames by (mf-1)/fps)."""
    if not svc.is_frequency or svc.slo_fps <= 0:
        return 1
    max_mf = int(svc.slo_latency_s * svc.slo_fps) + 1
    return max(1, min(max_mf, bs))


def _choose_dp(svc: ServiceSpec, gpu: GPUSpec, mp: int, bs: int, mt: int,
               mf: int, target_fps: Optional[float]) -> int:
    """Eq. 4: DP group count = ceil(required fps / fps of one group)."""
    if not svc.is_frequency or svc.slo_fps <= 0:
        return 1
    need = target_fps if target_fps else svc.slo_fps
    one_group = cm.throughput(svc, gpu, batch=bs, mp=mp, mt=mt)
    if one_group <= 0:
        return 1
    return max(1, math.ceil(need / one_group))


def allocate(svc: ServiceSpec, gpu: GPUSpec, *,
             user_mp: Optional[int] = None, user_bs: Optional[int] = None,
             target_fps: Optional[float] = None) -> ParallelPlan:
    """Full §3.1 + §4.1 pipeline for one service."""
    category = categorize(svc, gpu, target_fps=target_fps)
    allowed = operators_for(category)
    mp = _choose_mp(svc, gpu, user_mp) if Operator.MP in allowed else 1
    bs = _profile_bs(svc, gpu, mp, user_bs) if Operator.BS in allowed else 1
    mt = _profile_mt(svc, gpu, mp, bs) if Operator.MT in allowed else 1
    mf = _choose_mf(svc, bs) if Operator.MF in allowed else 1
    dp = (_choose_dp(svc, gpu, mp, bs, mt, mf, target_fps)
          if Operator.DP in allowed else 1)
    # prefill_chunk stays 0: the category-derived mapping in
    # ``prefill_chunk_tokens`` applies at the engine's block size (small
    # chunks for latency tasks, large for frequency/throughput)
    return ParallelPlan(service=svc.name, category=category, mp=mp, bs=bs,
                        mt=mt, mf=mf, dp=dp, sticky=svc.stateful)


def plan_goodput(svc: ServiceSpec, gpu: GPUSpec, plan: ParallelPlan, *,
                 cross_server: bool = False) -> float:
    """Theoretical goodput p̂ (reqs or frames /sec) of one deployed plan."""
    per_group = cm.throughput(svc, gpu, batch=plan.bs, mp=plan.mp,
                              mt=plan.mt, cross_server=cross_server)
    return per_group * plan.dp * plan.mt


# ---------------------------------------------------------------------------
# DP round-robin router (request-level allocation, Fig. 1)
# ---------------------------------------------------------------------------

class DPGroupRouter:
    """Round-robin frames/requests across DP replica groups; sessions of
    stateful archs (SSM/hybrid decode) stick to their group (DESIGN.md §5c)."""

    def __init__(self, plan: ParallelPlan):
        self.plan = plan
        self._next = 0
        self._sessions = {}

    def route(self, session: int = 0) -> int:
        if self.plan.sticky and session:
            if session not in self._sessions:
                self._sessions[session] = self._next
                self._next = (self._next + 1) % self.plan.dp
            return self._sessions[session]
        g = self._next
        self._next = (self._next + 1) % self.plan.dp
        return g

    def release(self, session: int) -> None:
        """Drop a session's group pin.  The serving engine calls this from
        its eviction hook once no request of the session remains queued or
        in flight — without it ``_sessions`` grows forever under a churn
        of short-lived sessions (one entry per session ever seen)."""
        self._sessions.pop(session, None)

    def sessions(self) -> int:
        """Live sticky-session pins (leak observability)."""
        return len(self._sessions)


# ---------------------------------------------------------------------------
# mesh mapping: EPARA plan -> TPU mesh axes (first-class launcher input)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """How a ParallelPlan tiles a (data, model) mesh: ``dp`` replica groups
    along ``data``, ``mp``-way sharding along ``model``."""
    data_parallel: int
    model_parallel: int
    batch_per_group: int

    @property
    def chips(self) -> int:
        return self.data_parallel * self.model_parallel


def mesh_submesh(plan: ParallelPlan) -> MeshPlan:
    return MeshPlan(data_parallel=plan.dp, model_parallel=plan.mp,
                    batch_per_group=plan.bs)
