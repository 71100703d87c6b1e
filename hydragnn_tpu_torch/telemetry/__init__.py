"""Telemetry (counterpart: hydragnn_tpu/telemetry):

* ``registry`` — the process-wide metrics registry (counters, gauges,
  histograms) with its JSONL event log and Prometheus text;
* ``spans`` — Chrome trace-event span recording and the opt-in
  `torch.profiler` device-trace bracket;
* ``http`` — the /healthz and /metrics endpoint of the serving engine;
* ``session`` — a training run's telemetry (its registry, recorder and
  artifacts);
* ``mfu`` — the card's peak FLOP/s and the achieved / peak gauge;
* ``gfm`` — a GFM mixture epoch's per-head losses and member fractions
  (`record_gfm_epoch`);
* ``sampling`` — sampled training's batches, historical-cache serves and
  fetched bytes (`record_sampled_batch`, `record_hist_refresh`).

Off by default at near-zero cost: producers call ``spans.record`` /
``spans.span`` (a None check with no recorder) and report registry
metrics from cold paths only.
"""
from .gfm import record_gfm_epoch
from .mfu import PEAK_FLOPS, achieved_and_mfu, peak_flops
from .sampling import record_hist_refresh, record_sampled_batch
from .registry import (COUNTER, GAUGE, HISTOGRAM, MetricsRegistry,
                       MetricTypeError, get_registry, set_registry)
from .session import TelemetryConfig, TelemetrySession, start_session
from .spans import (EpochDeviceTrace, SpanRecorder, current_recorder,
                    device_trace, install_recorder, record, span)

__all__ = [
    "PEAK_FLOPS", "achieved_and_mfu", "peak_flops", "record_gfm_epoch",
    "record_hist_refresh", "record_sampled_batch",
    "TelemetryConfig", "TelemetrySession", "start_session",
    "COUNTER", "GAUGE", "HISTOGRAM",
    "MetricsRegistry", "MetricTypeError", "get_registry", "set_registry",
    "EpochDeviceTrace", "SpanRecorder", "current_recorder", "device_trace",
    "install_recorder", "record", "span",
]
