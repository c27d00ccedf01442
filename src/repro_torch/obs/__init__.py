"""Observability layer: request-lifecycle tracing, metrics exposition,
and telemetry-calibrated simulation.

Three zero-dependency, host-side-only modules (enabling any of them
cannot change emitted tokens or compile counts — asserted by
``tests/test_obs.py``):

* ``obs.trace`` — span tracer with a bounded ring buffer and
  Chrome-trace-event JSON export (Perfetto-loadable).
* ``obs.metrics`` — counter/gauge/histogram registry with Prometheus
  text exposition and JSONL snapshots, fed per step by the engine.
* ``obs.calibrate`` — folds recorded telemetry back into ``SimConfig``
  overrides (``spec_accept_rate``, ``prefix_hit_rates``,
  ``prefill_token_s``) so placement prices against measured behavior.

Wiring: pass ``tracer=``/``metrics=`` to ``ServiceRuntime`` (the
launchers' ``--trace-out`` / ``--metrics-out`` / ``--calibrate-out``
flags do this for every deployed service).  Default is off:
``NULL_TRACER`` and no registry, byte-inert.
"""
from .calibrate import (ServiceTelemetry, calibrate, calibration_report,
                        merge_telemetry, telemetry_from_runtime,
                        telemetry_from_snapshot, telemetry_from_steps,
                        write_calibration)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      parse_prometheus_text, step_stat_sums)
from .trace import NULL_TRACER, Span, Tracer, validate_chrome_trace

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_TRACER",
    "ServiceTelemetry", "Span", "Tracer", "calibrate",
    "calibration_report", "merge_telemetry", "parse_prometheus_text",
    "step_stat_sums", "telemetry_from_runtime", "telemetry_from_snapshot",
    "telemetry_from_steps", "validate_chrome_trace", "write_calibration",
]
