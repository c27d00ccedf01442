"""Roofline cost model: per-(service, plan, GPU) latency & throughput.

The paper profiles services offline on P100s (§4.1); without that hardware
we derive the same quantities from a two-term roofline (compute vs HBM) per
GPU plus an MP communication penalty, preserving the *ratios* the paper's
claims rest on (DESIGN.md §4).  The allocator's "offline profiling" hooks,
the placement evaluator, and the event simulator all read from here, so
every layer prices work identically.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .categories import GPUSpec, ServiceSpec

# batching efficiency: marginal cost of extra batch elements (weights are
# amortized).  eff(1) = 1; large BS approaches the compute-bound floor.
_MP_COMM_OVERHEAD = 0.08           # per extra GPU: collective overhead
_MP_CROSS_SERVER_FACTOR = 6.0      # cross-server MP penalty (slow links)
_MT_INTERFERENCE = 0.06            # per co-located service slowdown
_FLOP_SAT = 4e9                    # work (FLOPs) needed to saturate a GPU:
#                                    below this, achieved FLOP/s scale with
#                                    the batch (occupancy) — this is what
#                                    makes batching worth up to ~10x for
#                                    small models (Fig. 3d's 6.9x)
_LAUNCH_OVERHEAD_S = 3e-4          # per-batch dispatch overhead
_MIN_UTIL = 0.04


def batch_latency(svc: ServiceSpec, gpu: GPUSpec, batch: int) -> float:
    """Roofline latency of a batch: compute at occupancy-scaled throughput
    vs streaming the weights once (batching amortizes both)."""
    work = batch * svc.flops_per_request / gpu.flops
    util = min(1.0, max(_MIN_UTIL,
                        batch * svc.flops_per_request / _FLOP_SAT))
    compute = work / util
    stream = svc.weights_bytes / (gpu.mem_bw_gbs * 1e9)
    return max(compute, stream) + 0.1 * min(compute, stream) \
        + _LAUNCH_OVERHEAD_S


def single_request_latency(svc: ServiceSpec, gpu: GPUSpec) -> float:
    """Batch-1 latency (streams the weights, poor occupancy)."""
    return batch_latency(svc, gpu, 1)


def mp_latency(svc: ServiceSpec, gpu: GPUSpec, mp: int, batch: int = 1, *,
               cross_server: bool = False) -> float:
    """Latency with ``mp``-way model parallelism (TP-like split)."""
    base = batch_latency(svc, gpu, batch)
    overhead = _MP_COMM_OVERHEAD * (mp - 1)
    if cross_server:
        overhead *= _MP_CROSS_SERVER_FACTOR
    return base / mp * (1.0 + overhead)


def throughput(svc: ServiceSpec, gpu: GPUSpec, *, batch: int = 1,
               mp: int = 1, mt: int = 1, cross_server: bool = False) -> float:
    """Requests/sec for one (mp-group) running the service with batch
    ``batch`` and ``mt`` co-located services sharing each GPU."""
    lat = mp_latency(svc, gpu, mp, batch, cross_server=cross_server)
    interference = 1.0 + _MT_INTERFERENCE * (mt - 1)
    return batch / (lat * interference) / mt


def effective_latency(svc: ServiceSpec, gpu: GPUSpec, *, batch: int = 1,
                      mp: int = 1, mt: int = 1, mf: int = 1,
                      cross_server: bool = False) -> float:
    """End-to-end latency a single request sees: queue-free service time
    plus the MF grouping delay (frames wait to fill the inter-frame batch:
    latency rises from 1/fps to mf/fps — §4.1)."""
    lat = mp_latency(svc, gpu, mp, batch, cross_server=cross_server)
    lat *= 1.0 + _MT_INTERFERENCE * (mt - 1)
    if mf > 1 and svc.slo_fps > 0:
        lat += (mf - 1) / svc.slo_fps
    return lat


def min_mp_for_vram(svc: ServiceSpec, gpu: GPUSpec) -> int:
    """Smallest power-of-two GPU count whose pooled VRAM fits the service
    (the paper's >1 GPU criterion)."""
    need = svc.vram_bytes
    mp = 1
    while mp * gpu.vram_bytes < need and mp < 1024:
        mp *= 2
    return mp


def fits_on(svc: ServiceSpec, gpu: GPUSpec, mp: int) -> bool:
    return svc.vram_bytes <= mp * gpu.vram_bytes


def vram_fraction(svc: ServiceSpec, gpu: GPUSpec, mp: int = 1) -> float:
    return svc.vram_bytes / (mp * gpu.vram_bytes)


def model_load_time(svc: ServiceSpec, bw_gbs: float) -> float:
    """Placement cost: time to ship + load weights (Fig. 3f motivation)."""
    return svc.weights_bytes / (bw_gbs * 1e9) + 0.35


def transfer_time(payload_bytes: float, bw_gbs: float) -> float:
    return payload_bytes / (bw_gbs * 1e9) + 0.002  # + fixed RTT
