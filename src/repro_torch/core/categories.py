"""EPARA task categories and allocation operators (§3.1, Fig. 5).

A *task* = (request, service).  Tasks are categorized on two axes:

* sensitivity — ``latency`` (non-continuous requests; latency is the sole
  SLO) vs ``frequency`` (continuous/periodic requests; frame-rate is the
  binding SLO, latency a baseline expectation);
* resource — ``<=1 GPU`` vs ``>1 GPU`` (whether the model needs multi-GPU
  collaboration, from VRAM fit and/or latency).

Five allocation operators: BS, MT, MP (service-level), MF, DP
(request-level).  ``OPERATORS_BY_CATEGORY`` reproduces Fig. 5's mapping.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import FrozenSet, Optional, Tuple


class Sensitivity(str, enum.Enum):
    LATENCY = "latency"
    FREQUENCY = "frequency"


class Outcome(str, enum.Enum):
    """The system's ONE verdict vocabulary, shared by the distributed
    handler (§3.2 routing decisions), the serving engine's admission
    controller (``serving/admission.py``) and the simulator's counters —
    so a request's fate is never stringly-typed and a doomed admission can
    be routed by exactly the machinery that routes a fresh arrival.

    Handler routing outcomes (Fig. 6):

    * ``LOCAL`` / ``LOCAL_CROSS`` / ``LOCAL_DEVICE`` — solve here, by the
      §3.2 priority ladder;
    * ``OFFLOAD`` — forward to a peer (also the admission controller's
      "still feasible elsewhere" verdict: positive slack, but the local
      queue would burn it);
    * ``TIMEOUT`` — the SLO already expired before any work started;
    * ``OFFLOAD_EXCEEDED`` / ``INSUFFICIENT`` — bounded hop count / no
      feasible server at all.

    Admission-control verdicts (Icarus-style explicit admission results):

    * ``ADMIT`` — claimed a decode slot;
    * ``DEADLINE_MISSED`` — the slack estimate says the request cannot
      finish ANYWHERE in time (deadline passed or service time alone
      exceeds the remaining budget) — shed it instead of serving dead
      work;
    * ``CONGESTION`` — hard local backpressure (queue beyond the
      congestion bound); the request itself may still be feasible on an
      idle peer, so the handler treats this like a saturated-local signal.

    Fault-tolerance verdict (§5.3.3 recovery, ``core/faults.py``):

    * ``FAILED`` — the request was lost to an injected or real fault
      (crashed server, dropped offload) and could not be replayed on any
      survivor within its retry budget.  The TERMINAL verdict of the
      recovery path: every rid must end served-or-verdicted, so a request
      that exhausts its failover attempts carries this instead of
      silently vanishing with its dead arena.
    """
    LOCAL = "local"                       # solve on this server's GPUs
    LOCAL_CROSS = "local_cross_server"    # cross-server-parallel group
    LOCAL_DEVICE = "local_edge_device"    # registered edge device
    OFFLOAD = "offload"
    TIMEOUT = "timeout"
    OFFLOAD_EXCEEDED = "offload_exceeded"
    INSUFFICIENT = "resource_insufficiency"
    ADMIT = "admit"
    DEADLINE_MISSED = "deadline_missed"
    CONGESTION = "congestion"
    FAILED = "failed"


# Admission verdicts a rejected request can carry (every non-admitted
# request MUST carry exactly one of these — no verdict-less drops).
REJECT_VERDICTS = (Outcome.DEADLINE_MISSED, Outcome.CONGESTION,
                   Outcome.OFFLOAD, Outcome.FAILED)


class Operator(str, enum.Enum):
    BS = "batching"          # service-level: same-service batch
    MT = "multi_task"        # service-level: co-locate services on one GPU
    MP = "model_parallelism"  # service-level: TP/PP across GPUs
    MF = "multi_frame"       # request-level: frames of homogeneous tasks
    DP = "data_parallelism"  # request-level: round-robin replica groups


@dataclasses.dataclass(frozen=True)
class TaskCategory:
    sensitivity: Sensitivity
    multi_gpu: bool

    @property
    def key(self) -> Tuple[str, bool]:
        return (self.sensitivity.value, self.multi_gpu)

    def __str__(self) -> str:
        g = ">1gpu" if self.multi_gpu else "<=1gpu"
        return f"{self.sensitivity.value}/{g}"


CAT_LAT_SINGLE = TaskCategory(Sensitivity.LATENCY, False)
CAT_LAT_MULTI = TaskCategory(Sensitivity.LATENCY, True)
CAT_FREQ_SINGLE = TaskCategory(Sensitivity.FREQUENCY, False)
CAT_FREQ_MULTI = TaskCategory(Sensitivity.FREQUENCY, True)

ALL_CATEGORIES = (CAT_LAT_SINGLE, CAT_LAT_MULTI, CAT_FREQ_SINGLE,
                  CAT_FREQ_MULTI)

# Fig. 5: which operators apply to which category.
OPERATORS_BY_CATEGORY = {
    CAT_LAT_SINGLE.key: frozenset({Operator.BS, Operator.MT}),
    CAT_LAT_MULTI.key: frozenset({Operator.BS, Operator.MT, Operator.MP}),
    CAT_FREQ_SINGLE.key: frozenset({Operator.BS, Operator.MT, Operator.MF}),
    CAT_FREQ_MULTI.key: frozenset({Operator.BS, Operator.MT, Operator.MP,
                                   Operator.MF, Operator.DP}),
}


def operators_for(category: TaskCategory) -> FrozenSet[Operator]:
    return OPERATORS_BY_CATEGORY[category.key]


# Prefix-cache retention by sensitivity (§3.1 applied to KV reuse):
# frequency tasks are periodic repeats of the same system/prompt prefix
# (sensor pipelines, templated LLM calls), so their serving plans retain
# cached prefix blocks aggressively — every reclaimable block stays until
# arena pressure forces LRU eviction.  Latency tasks see mostly one-off
# prompts; holding a large idle cache only delays block reuse, so their
# retention is bounded to a fraction of the pool.
PREFIX_RETENTION_FRACTION = {
    Sensitivity.FREQUENCY: 1.0,
    Sensitivity.LATENCY: 0.25,
}


# Paged-KV precision by sensitivity (§3.1 applied to cache residency):
# frequency tasks run long periodic streams whose decode cost is dominated
# by KV traffic, and their outputs feed rate-driven pipelines that tolerate
# small numeric drift — int8 block quantization (per-token-per-head scales)
# cuts their decode bytes/token roughly 2x and doubles effective arena
# residency.  Latency tasks are one-shot and accuracy-facing; they keep
# the model's native KV dtype ("bf16" = whatever the model computes in).
KV_DTYPE_BY_SENSITIVITY = {
    Sensitivity.FREQUENCY: "int8",
    Sensitivity.LATENCY: "bf16",
}


# Speculative decoding by sensitivity (§3.1 applied to tokens/step):
# latency tasks buy raw per-request speed — a small draft model proposes k
# tokens per round and the fused paged step verifies them in ONE launch,
# multiplying tokens per target launch by up to k+1.  Frequency tasks
# already saturate the device with batch (BS is their operator); running a
# draft model would steal exactly the capacity their frame-rate SLO is
# spending, so they never speculate.
SPECULATE_BY_SENSITIVITY = {
    Sensitivity.LATENCY: 4,
    Sensitivity.FREQUENCY: 0,
}


# Parallel sampling (n>1) by sensitivity: frequency tasks are throughput
# buyers — n-way sampling rides as refcounted forks sharing the prompt's
# paged blocks (COW on divergence), i.e. more tokens/step from machinery
# the batch already paid for (0 = cap at the plan's batch size).  Latency
# tasks want the single fastest answer; forks would only dilute their
# slots.
PARALLEL_SAMPLES_BY_SENSITIVITY = {
    Sensitivity.FREQUENCY: 0,
    Sensitivity.LATENCY: 1,
}


# ---------------------------------------------------------------------------
# services & requests (shared by live engine + simulator)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """A deployable AI service (one model + SLO contract)."""
    name: str
    flops_per_request: float          # fwd FLOPs for one request/frame
    weights_bytes: float              # model weights (placement/load cost)
    vram_bytes: float                 # weights + activations + cache budget
    sensitivity: Sensitivity = Sensitivity.LATENCY
    slo_latency_s: float = 0.5        # latency SLO (both kinds)
    slo_fps: float = 0.0              # frequency SLO (frequency kind only)
    request_bytes: float = 32_768.0   # network payload per request
    arch: Optional[str] = None        # assigned-architecture id, if any
    stateful: bool = False            # SSM/hybrid decode: sticky DP routing
    priority: bool = False            # S1 priority placement list member
    prefix_cacheable: bool = True     # paged KV is a pure function of the
    #                                   prompt tokens (dense/MoE) — the
    #                                   serving engine's prefix-cache gate;
    #                                   the simulator's hit-rate discount
    #                                   applies only when True

    @property
    def is_frequency(self) -> bool:
        return self.sensitivity == Sensitivity.FREQUENCY


@dataclasses.dataclass
class Request:
    """One user request; frequency tasks carry ``frames``/``duration_s``."""
    rid: int
    service: str
    arrival_s: float
    frames: int = 1                  # 1 for latency tasks
    duration_s: float = 0.0          # stream duration for frequency tasks
    prompt_tokens: int = 0           # prompt length (chunked-prefill cost
    #                                  model; 0 = prefill not modeled)
    template: int = 0                # shared-prompt-template id (prefix-
    #                                  cache structure; 0 = one-off prompt)
    deadline_s: float = 0.0          # arrival + SLO (latency tasks)
    path: Tuple[int, ...] = ()       # servers traversed (loop prevention)
    offload_count: int = 0
    session: int = 0                 # sticky-routing key for stateful archs

    def on_path(self, server_id: int) -> bool:
        return server_id in self.path


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str = "tpu-v5e-slice"
    tflops: float = 197.0            # bf16 peak per chip (target hw)
    vram_gb: float = 16.0            # HBM per chip
    mem_bw_gbs: float = 819.0

    @property
    def vram_bytes(self) -> float:
        return self.vram_gb * 1e9

    @property
    def flops(self) -> float:
        return self.tflops * 1e12


# The paper's testbed GPU (Tesla P100 16GB): simulator benchmarks use this
# so goodput ratios are comparable to the paper's; the TPU spec above is
# the dry-run/roofline target hardware.
EDGE_P100 = GPUSpec(name="tesla-p100", tflops=19.0, vram_gb=16.0,
                    mem_bw_gbs=732.0)
EDGE_JETSON = GPUSpec(name="jetson-like", tflops=1.3, vram_gb=4.0,
                      mem_bw_gbs=60.0)


@dataclasses.dataclass
class ServerSpec:
    """An edge server = a co-located group of GPUs (TPU chips)."""
    sid: int
    num_gpus: int = 4
    gpu: GPUSpec = dataclasses.field(default_factory=GPUSpec)
    intra_bw_gbs: float = 50.0       # ICI within the server
    inter_bw_gbs: float = 1.25       # WAN/DCN to peer servers (10 Gb/s)

    @property
    def total_vram(self) -> float:
        return self.num_gpus * self.gpu.vram_bytes
