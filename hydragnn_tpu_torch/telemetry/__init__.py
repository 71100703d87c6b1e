"""Telemetry (counterpart: hydragnn_tpu/telemetry):

* ``registry`` — the process-wide metrics registry (counters, gauges,
  histograms) with its JSONL event log and Prometheus text;
* ``spans`` — Chrome trace-event span recording and the opt-in
  `torch.profiler` device-trace bracket;
* ``http`` — the /healthz and /metrics endpoint of the serving engine.

Off by default at near-zero cost: producers call ``spans.record`` /
``spans.span`` (a None check with no recorder) and report registry
metrics from cold paths only. The JAX package's ``session``, ``mfu``,
``gfm`` and ``sampling`` are not ported yet (ROADMAP A8).
"""
from .registry import (COUNTER, GAUGE, HISTOGRAM, MetricsRegistry,
                       MetricTypeError, get_registry, set_registry)
from .spans import (EpochDeviceTrace, SpanRecorder, current_recorder,
                    device_trace, install_recorder, record, span)

__all__ = [
    "COUNTER", "GAUGE", "HISTOGRAM",
    "MetricsRegistry", "MetricTypeError", "get_registry", "set_registry",
    "EpochDeviceTrace", "SpanRecorder", "current_recorder", "device_trace",
    "install_recorder", "record", "span",
]
