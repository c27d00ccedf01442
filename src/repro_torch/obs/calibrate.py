"""Telemetry -> simulator calibration: close the measure -> model ->
place loop.

The placement layer prices services with the event-driven simulator
(``repro_torch/simulator/engine.py``), whose ``SimConfig`` carries behavioral
knobs the live data plane actually measures every step: the speculative
acceptance rate, per-service prefix-cache hit rates, and the per-token
prefill cost.  Before this module those knobs were hand-tuned (or
derived a priori from the workload generator); now a recorded serve —
``StepStats`` aggregates, a metrics snapshot, or live runtimes — folds
back into a calibrated ``SimConfig``, so the simulator the placement
layer prices against reflects what the deployment just did.

Derivations (each documented against the SimConfig field it feeds):

* ``spec_accept_rate`` — the sim commits ``1 + rate*k`` tokens per
  fused verify launch, so the measured rate is
  ``(accepted_tokens / verify_launches - 1) / k``, aggregated across
  speculating services weighted by their launch counts and clamped to
  [0, 1].
* ``prefix_hit_rates[service]`` — cached prompt tokens over total
  prompt tokens: ``hit_tokens / (hit_tokens + prefill_tokens_computed)``
  (the exact quantity the sim's hit-rate discount multiplies).
* ``prefill_token_s`` — measured prefill wall seconds per computed
  prompt token, when the run recorded both (else the base value
  stands).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, Mapping, Optional

from repro_torch.simulator.engine import SimConfig

from .metrics import step_stat_sums


@dataclasses.dataclass
class ServiceTelemetry:
    """One service's calibration-relevant aggregates over a run."""
    service: str
    spec_k: int = 0                  # draft depth the service ran with
    accepted_tokens: int = 0         # target tokens committed by verify
    verify_launches: int = 0
    prefix_hit_tokens: int = 0       # prompt tokens served from cache
    prefill_tokens_computed: int = 0  # prompt tokens run through compute
    prefill_seconds: float = 0.0     # per-request prefill wall seconds
    decode_steps: int = 0

    @property
    def spec_accept_rate(self) -> Optional[float]:
        """Measured acceptance rate, in the sim's ``1 + rate*k`` frame;
        None when the service never speculated."""
        if self.spec_k <= 0 or self.verify_launches <= 0:
            return None
        per_launch = self.accepted_tokens / self.verify_launches
        return min(1.0, max(0.0, (per_launch - 1.0) / self.spec_k))

    @property
    def prefix_hit_rate(self) -> Optional[float]:
        """Measured cached-prompt-token fraction; None when the run saw
        no prompt tokens at all."""
        total = self.prefix_hit_tokens + self.prefill_tokens_computed
        if total <= 0:
            return None
        return self.prefix_hit_tokens / total

    @property
    def prefill_token_s(self) -> Optional[float]:
        if self.prefill_tokens_computed <= 0 or self.prefill_seconds <= 0:
            return None
        return self.prefill_seconds / self.prefill_tokens_computed


def telemetry_from_steps(service: str, steps: Iterable,
                         spec_k: int = 0) -> ServiceTelemetry:
    """Build telemetry from recorded ``StepStats`` — the same
    ``step_stat_sums`` fold the metrics registry and the benchmark
    aggregator run, so "measured aggregates" means one thing
    everywhere.  ``prefill_tokens_computed`` counts chunked prefill
    tokens net of cache hits (hit tokens never enter the (b2) budget);
    prefill seconds come from the finished results' own timings."""
    sums: Dict[str, float] = {}
    prefill_s = 0.0
    for st in steps:
        step_stat_sums(st, into=sums)
        prefill_s += sum(r.prefill_s for r in st.results)
    return ServiceTelemetry(
        service=service, spec_k=int(spec_k),
        accepted_tokens=int(sums.get("accepted_tokens", 0)),
        verify_launches=int(sums.get("verify_launches", 0)),
        prefix_hit_tokens=int(sums.get("prefix_hit_tokens", 0)),
        prefill_tokens_computed=int(sums.get("prefill_chunk_tokens", 0)),
        prefill_seconds=prefill_s,
        decode_steps=int(sums.get("decode_steps", 0)))


def telemetry_from_runtime(service: str, runtime) -> ServiceTelemetry:
    """Build telemetry straight off a live ``ServiceRuntime``'s
    cumulative counters (the launcher's path: exact, no sampling)."""
    return ServiceTelemetry(
        service=service, spec_k=runtime.speculate_k,
        accepted_tokens=runtime.accepted_tokens,
        verify_launches=runtime.verify_launches,
        prefix_hit_tokens=runtime.prefix_hit_tokens,
        prefill_tokens_computed=runtime.prefill_tokens_computed,
        prefill_seconds=runtime.prefill_seconds,
        decode_steps=runtime.decode_steps)


def merge_telemetry(items: Iterable[ServiceTelemetry]
                    ) -> Dict[str, ServiceTelemetry]:
    """Sum telemetry records by service name — a cluster run hosts the
    same service on several runtimes (one per server), and the measured
    counters are additive.  ``spec_k`` must agree across replicas (it is
    a plan knob, not a counter); a mismatch raises rather than averaging
    incomparable acceptance frames."""
    out: Dict[str, ServiceTelemetry] = {}
    for t in items:
        prev = out.get(t.service)
        if prev is None:
            out[t.service] = dataclasses.replace(t)
            continue
        if prev.spec_k != t.spec_k:
            raise ValueError(
                f"service {t.service!r} replicas disagree on spec_k "
                f"({prev.spec_k} vs {t.spec_k}); cannot merge acceptance "
                "telemetry across different draft depths")
        prev.accepted_tokens += t.accepted_tokens
        prev.verify_launches += t.verify_launches
        prev.prefix_hit_tokens += t.prefix_hit_tokens
        prev.prefill_tokens_computed += t.prefill_tokens_computed
        prev.prefill_seconds += t.prefill_seconds
        prev.decode_steps += t.decode_steps
    return out


def telemetry_from_snapshot(snapshot: Mapping[str, Any]
                            ) -> Dict[str, ServiceTelemetry]:
    """Rebuild per-service telemetry from a ``MetricsRegistry``
    snapshot (the JSONL record) — the offline path: a metrics file from
    a past run calibrates without re-running anything."""
    def series(name: str) -> Dict[str, float]:
        m = snapshot.get("metrics", {}).get(f"epara_{name}")
        out: Dict[str, float] = {}
        if not m:
            return out
        for row in m.get("values", []):
            svc = row.get("labels", {}).get("service", "")
            out[svc] = row.get("value", row.get("sum", 0.0))
        return out

    accepted = series("step_accepted_tokens_total")
    launches = series("step_verify_launches_total")
    hit_tokens = series("step_prefix_hit_tokens_total")
    computed = series("prefill_tokens_computed")
    spec_k = series("spec_k")
    prefill_s = series("prefill_seconds_total")
    steps = series("step_decode_steps_total")
    names = (set(accepted) | set(launches) | set(hit_tokens)
             | set(computed) | set(spec_k))
    return {svc: ServiceTelemetry(
        service=svc, spec_k=int(spec_k.get(svc, 0)),
        accepted_tokens=int(accepted.get(svc, 0)),
        verify_launches=int(launches.get(svc, 0)),
        prefix_hit_tokens=int(hit_tokens.get(svc, 0)),
        prefill_tokens_computed=int(computed.get(svc, 0)),
        prefill_seconds=prefill_s.get(svc, 0.0),
        decode_steps=int(steps.get(svc, 0))) for svc in sorted(names)}


def calibrate(telemetry: Mapping[str, ServiceTelemetry],
              base: Optional[SimConfig] = None) -> SimConfig:
    """Fold measured telemetry into ``SimConfig`` overrides.  Fields a
    run did not measure keep the base value — a cold run (no
    speculation, no prompts) calibrates to exactly the base config, so
    the loop is safe to run unconditionally."""
    base = SimConfig() if base is None else base
    over: Dict[str, Any] = {}
    # spec_accept_rate is a single scalar: launch-weighted mean across
    # the services that actually speculated
    num = den = 0.0
    for t in telemetry.values():
        r = t.spec_accept_rate
        if r is not None:
            num += r * t.verify_launches
            den += t.verify_launches
    if den > 0:
        over["spec_accept_rate"] = num / den
    rates = {t.service: t.prefix_hit_rate for t in telemetry.values()
             if t.prefix_hit_rate is not None}
    if rates:
        merged = dict(base.prefix_hit_rates or {})
        merged.update(rates)
        over["prefix_hit_rates"] = merged
    # prefill cost: token-weighted mean across services that timed it
    pnum = pden = 0.0
    for t in telemetry.values():
        s = t.prefill_token_s
        if s is not None:
            pnum += s * t.prefill_tokens_computed
            pden += t.prefill_tokens_computed
    if pden > 0:
        over["prefill_token_s"] = pnum / pden
    return dataclasses.replace(base, **over) if over else base


def calibration_report(telemetry: Mapping[str, ServiceTelemetry],
                       cfg: SimConfig) -> Dict[str, Any]:
    """The JSON document ``--calibrate-out`` writes: the derived
    ``SimConfig`` overrides plus per-service provenance, so the next
    session can audit WHERE each number came from."""
    return {
        "sim_config_overrides": {
            "spec_accept_rate": cfg.spec_accept_rate,
            "prefix_hit_rates": dict(cfg.prefix_hit_rates or {}),
            "prefill_token_s": cfg.prefill_token_s,
        },
        "telemetry": {
            name: {
                "spec_k": t.spec_k,
                "accepted_tokens": t.accepted_tokens,
                "verify_launches": t.verify_launches,
                "spec_accept_rate": t.spec_accept_rate,
                "prefix_hit_tokens": t.prefix_hit_tokens,
                "prefill_tokens_computed": t.prefill_tokens_computed,
                "prefix_hit_rate": t.prefix_hit_rate,
                "prefill_token_s": t.prefill_token_s,
                "decode_steps": t.decode_steps,
            } for name, t in sorted(telemetry.items())
        },
    }


def write_calibration(path: str,
                      telemetry: Mapping[str, ServiceTelemetry],
                      base: Optional[SimConfig] = None) -> SimConfig:
    cfg = calibrate(telemetry, base)
    with open(path, "w") as f:
        json.dump(calibration_report(telemetry, cfg), f, indent=2)
    return cfg
