"""Counter / gauge / histogram registry with Prometheus text exposition
and JSONL snapshots.

Zero-dependency and host-side only (like ``obs/trace.py``): the registry
is fed numbers the engine already computes — ``StepStats`` counter
deltas, per-request timings at eviction, arena occupancy — so enabling
it cannot change tokens or compile counts.

``step_stat_sums`` is THE StepStats summing primitive: it folds every
numeric field of a ``StepStats`` (or any dataclass of counters) into an
accumulator dict.  The benchmark aggregator (``benchmarks/common.py``)
and the registry's ``observe_step`` both call it, so "sum the step
telemetry" exists exactly once.

Exposition formats:

* ``prometheus_text()`` — the Prometheus text format (``# HELP`` /
  ``# TYPE`` / ``name{label="v"} value``; histograms with cumulative
  ``_bucket{le=...}`` + ``_sum`` + ``_count`` series).
* ``snapshot()`` / ``append_jsonl(path)`` — one JSON object per call
  with every series' current value, for offline analysis and the
  calibration loop (``obs/calibrate.py`` can rebuild service telemetry
  from a snapshot alone).
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

# -- shared StepStats summing (the one copy of the fold) ----------------

# fields that are per-step LEVELS (not deltas): summing them across steps
# would double-count standing state, so the fold skips them
_LEVEL_FIELDS = frozenset({"now", "in_flight", "pending", "parked",
                           "queue_time_s", "spec_slots"})


def step_stat_sums(stats, into: Optional[Dict[str, float]] = None,
                   ) -> Dict[str, float]:
    """Fold one telemetry record's numeric delta fields into ``into``
    (list-valued fields like ``results``/``rejected`` and per-step level
    fields like ``in_flight`` are skipped).  Works on any dataclass of
    counters — ``StepStats`` today, without importing the serving engine
    (no circular dependency)."""
    acc = {} if into is None else into
    for f in dataclasses.fields(stats):
        if f.name in _LEVEL_FIELDS:
            continue
        v = getattr(stats, f.name)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        acc[f.name] = acc.get(f.name, 0) + v
    return acc


# -- metric primitives --------------------------------------------------

DEFAULT_LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                           0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Mapping[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v)


class Counter:
    """Monotonically increasing value per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str):
        self.name, self.help = name, help
        self._values: Dict[Tuple, float] = {}

    def inc(self, v: float = 1.0, **labels) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {v}")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + v

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def expose(self) -> List[str]:
        return [f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"
                for k, v in sorted(self._values.items())]

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind,
                "values": [{"labels": dict(k), "value": v}
                           for k, v in sorted(self._values.items())]}


class Gauge(Counter):
    """Set-to-current value per label set (occupancy, queue depth)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        self._values[_label_key(labels)] = float(v)

    def inc(self, v: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + v


class Histogram:
    """Fixed-bucket histogram: per label set, cumulative bucket counts
    (Prometheus ``le`` semantics: ``count(x <= le)``), plus sum/count."""

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS):
        self.name, self.help = name, help
        bs = sorted(set(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name} needs >= 1 finite bucket")
        if bs[-1] != math.inf:
            bs.append(math.inf)
        self.buckets = tuple(bs)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sum: Dict[Tuple, float] = {}
        self._n: Dict[Tuple, int] = {}

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        counts = self._counts.setdefault(key, [0] * len(self.buckets))
        for i, le in enumerate(self.buckets):
            if v <= le:
                counts[i] += 1
                break
        self._sum[key] = self._sum.get(key, 0.0) + v
        self._n[key] = self._n.get(key, 0) + 1

    def value(self, **labels) -> Dict[str, Any]:
        """Cumulative bucket counts + sum + count for one label set."""
        key = _label_key(labels)
        counts = self._counts.get(key, [0] * len(self.buckets))
        cum, acc = [], 0
        for c in counts:
            acc += c
            cum.append(acc)
        return {"buckets": dict(zip((_fmt_value(b) for b in self.buckets),
                                    cum)),
                "sum": self._sum.get(key, 0.0),
                "count": self._n.get(key, 0)}

    def expose(self) -> List[str]:
        out = []
        for key in sorted(self._counts):
            acc = 0
            for le, c in zip(self.buckets, self._counts[key]):
                acc += c
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels(key, (('le', _fmt_value(le)),))}"
                           f" {acc}")
            out.append(f"{self.name}_sum{_fmt_labels(key)} "
                       f"{_fmt_value(self._sum[key])}")
            out.append(f"{self.name}_count{_fmt_labels(key)} "
                       f"{self._n[key]}")
        return out

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind,
                "values": [{"labels": dict(k), **self.value(**dict(k))}
                           for k in sorted(self._counts)]}


class MetricsRegistry:
    """Named metric registry + the serving-stack feed methods.

    The engine calls ``observe_step`` once per scheduling round and
    ``observe_request`` once per finished request; everything else
    (exposition, snapshots, calibration reads) is pull-based."""

    def __init__(self, namespace: str = "epara"):
        self.namespace = namespace
        self._metrics: Dict[str, Any] = {}

    # -- registration ---------------------------------------------------
    def _register(self, cls, name: str, help: str, **kw):
        full = f"{self.namespace}_{name}" if self.namespace else name
        m = self._metrics.get(full)
        if m is None:
            m = cls(full, help, **kw)
            self._metrics[full] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {full} already registered as "
                             f"{m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    # -- serving-stack feeds --------------------------------------------
    def observe_step(self, service: str, stats, runtime=None) -> None:
        """Fold one ``StepStats`` into the registry: every numeric delta
        field becomes a ``step_<field>_total`` counter (via the shared
        ``step_stat_sums`` fold — the same logic the benchmark
        aggregator runs), level fields become gauges, and the runtime
        (when given) contributes arena occupancy + compile counts +
        calibration inputs."""
        sums = step_stat_sums(stats)
        for field, v in sums.items():
            if v:
                self.counter(f"step_{field}_total",
                             f"sum of StepStats.{field} across steps"
                             ).inc(v, service=service)
        self.gauge("in_flight", "occupied decode slots").set(
            stats.in_flight, service=service)
        self.gauge("pending", "queued requests").set(
            stats.pending, service=service)
        self.gauge("parked", "preempted requests holding frozen blocks"
                   ).set(stats.parked, service=service)
        self.gauge("queue_time_estimate_seconds",
                   "engine's queue-wait estimate for a new arrival").set(
            stats.queue_time_s, service=service)
        self.counter("steps_total", "scheduling rounds").inc(
            1, service=service)
        if stats.results:
            self.counter("requests_finished_total",
                         "requests that completed decode").inc(
                len(stats.results), service=service)
            self.counter("tokens_generated_total",
                         "tokens emitted by finished requests").inc(
                sum(len(r.tokens) for r in stats.results),
                service=service)
            self.counter("prefill_seconds_total",
                         "per-request prefill wall seconds").inc(
                sum(r.prefill_s for r in stats.results), service=service)
        if runtime is not None:
            self.observe_runtime(service, runtime)

    def observe_runtime(self, service: str, runtime) -> None:
        """Gauges read straight off the runtime's cumulative state:
        arena block occupancy, compile counts, calibration inputs
        (``spec_k`` so a snapshot alone can derive the acceptance
        rate)."""
        used = total = 0
        for g in runtime.groups.values():
            arena = g.arena
            if arena is None:
                continue
            total += arena.pool_blocks
            used += arena.pool_blocks - arena.free_capacity
        if total:
            self.gauge("arena_blocks_used", "allocated arena blocks"
                       ).set(used, service=service)
            self.gauge("arena_block_occupancy_ratio",
                       "allocated / pool blocks").set(
                used / total, service=service)
        self.gauge("decode_compiles", "fused decode step traces").set(
            runtime.decode_traces, service=service)
        self.gauge("prefill_compiles", "prefill/chunk traces").set(
            runtime.prefill_traces, service=service)
        self.gauge("prefill_tokens_computed",
                   "prompt tokens run through prefill compute").set(
            runtime.prefill_tokens_computed, service=service)
        self.gauge("spec_k", "speculative draft depth (0 = off)").set(
            runtime.speculate_k, service=service)

    def observe_request(self, service: str, *, ttft_s: float,
                        tpot_s: Optional[float], queue_wait_s: float,
                        new_tokens: int) -> None:
        """Per-request latency decomposition, recorded at eviction."""
        self.histogram("ttft_seconds",
                       "admission -> first token").observe(
            max(0.0, ttft_s), service=service)
        if tpot_s is not None:
            self.histogram("tpot_seconds",
                           "per-token decode latency").observe(
                max(0.0, tpot_s), service=service)
        self.histogram("queue_wait_seconds",
                       "submit -> admission").observe(
            max(0.0, queue_wait_s), service=service)
        self.histogram(
            "request_tokens", "tokens generated per request",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
        ).observe(new_tokens, service=service)

    # -- exposition -----------------------------------------------------
    def prometheus_text(self) -> str:
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.prometheus_text())

    def snapshot(self) -> Dict[str, Any]:
        return {"ts": time.time(),
                "metrics": {name: m.snapshot()
                            for name, m in sorted(self._metrics.items())}}

    def append_jsonl(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(json.dumps(self.snapshot()) + "\n")


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Minimal parser of the Prometheus text format — the CI smoke gate
    and the tests' round-trip check.  Returns ``{series: value}`` keyed
    by ``name{labels}``; raises ``ValueError`` on any malformed line."""
    out: Dict[str, float] = {}
    for i, line in enumerate(text.splitlines()):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(" ", 1)
        except ValueError:
            raise ValueError(f"line {i}: no value separator: {line!r}")
        if "{" in series and not series.endswith("}"):
            raise ValueError(f"line {i}: unbalanced labels: {line!r}")
        out[series] = math.inf if value == "+Inf" else float(value)
    if not out:
        raise ValueError("no samples in exposition")
    return out
