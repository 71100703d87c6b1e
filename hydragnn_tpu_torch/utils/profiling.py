"""Latency summary shared by the serving engine, the fleet and the
publisher, and the trainer's host-stall accounting (counterpart:
hydragnn_tpu/utils/profiling.py `latency_percentiles`,
`HostStallMonitor`)."""
from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np

from ..telemetry import spans as _spans


def latency_percentiles(latencies_s, percentiles=(50, 95, 99)
                        ) -> Dict[str, float]:
    """{"p50_ms", "p95_ms", "p99_ms", "mean_ms", "count"} from latencies
    in seconds. The full key set is always there: no latencies give
    zeros with `count` 0."""
    lat = np.asarray(list(latencies_s), np.float64)
    out: Dict[str, float] = {f"p{int(q)}_ms": 0.0 for q in percentiles}
    out["mean_ms"] = 0.0
    out["count"] = 0
    if lat.size == 0:
        return out
    for q in percentiles:
        out[f"p{int(q)}_ms"] = float(np.percentile(lat, q) * 1e3)
    out["mean_ms"] = float(lat.mean() * 1e3)
    out["count"] = int(lat.size)
    return out


class HostStallMonitor:
    """One epoch's host time blocked on the input pipeline against the
    time in steps.

    `wrap(stream)` times every `next()` on the batch stream (collation:
    what the card waits on); `step_timer()` wraps a step. The trainer
    puts the step's host read of its metrics inside the timer, and that
    read waits for the card, so `step_s` is dispatch and execution (a
    CUDA-graph replay alone returns at launch). `input_bound_frac()` is
    wait / (wait + step). Each interval is also a span, `dataload_wait`
    or `step_dispatch` (cat "tracer"), while a recorder is installed."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.wait_s = 0.0
        self.step_s = 0.0

    def wrap(self, stream):
        it = iter(stream)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                dt = time.perf_counter() - t0
                self.wait_s += dt
                _spans.record("dataload_wait", t0, dt, cat="tracer")
            yield batch

    @contextlib.contextmanager
    def step_timer(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.step_s += dt
            _spans.record("step_dispatch", t0, dt, cat="tracer")

    def input_bound_frac(self) -> float:
        total = self.wait_s + self.step_s
        return self.wait_s / total if total > 0 else 0.0
