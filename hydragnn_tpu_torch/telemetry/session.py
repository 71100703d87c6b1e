"""TelemetrySession: one training run's telemetry (counterpart:
hydragnn_tpu/telemetry/session.py, copied).

    cfg = utils.envflags.resolve_telemetry(train_cfg)   # strict knobs
    session = start_session(cfg, run_dir)               # None when off
    ...                                                 # layers report in
    paths = session.finalize()                          # the artifacts

While a session is live, a fresh MetricsRegistry is the process registry
(so the exports hold this run only; counters reported before it started
are carried in) and a SpanRecorder is installed in telemetry/spans,
which turns every span call site on. `finalize()` writes telemetry.jsonl,
trace.json and metrics.prom and puts both back, so a session never leaks
into a later run. The knobs are resolved in utils/envflags, not here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from .registry import MetricsRegistry, set_registry
from .spans import SpanRecorder, install_recorder


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Resolved telemetry knobs (utils/envflags.resolve_telemetry); off
    by default."""
    enabled: bool = False
    out_dir: Optional[str] = None      # None = <run_dir>/telemetry
    device_trace: bool = False         # a torch.profiler trace of an epoch
    device_trace_epoch: int = 0        # the epoch it captures

    def resolve_out_dir(self, run_dir: str) -> str:
        """The one artifact directory: the session's files and
        run_training's device trace both go here."""
        return self.out_dir or os.path.join(run_dir, "telemetry")


class TelemetrySession:
    """One run's telemetry: a run-scoped registry and span recorder and
    the memo of the FLOP probe. Made by `start_session`."""

    def __init__(self, config: TelemetryConfig, run_dir: str):
        self.config = config
        self.out_dir = config.resolve_out_dir(run_dir)
        self.compute_dtype = "float32"
        # a pipelined run's schedule (run_training.pipeline_info), which
        # the trainer reports as gauges, spans and epoch-event fields
        self.pipeline_info = None
        self.registry = MetricsRegistry()
        self.recorder = SpanRecorder()
        self._prev_registry = set_registry(self.registry)
        # counters reported before the session (dataset build) carry in
        self.registry.seed_from(self._prev_registry)
        self._prev_recorder = install_recorder(self.recorder)
        self._flops_per_step: Optional[float] = None
        self._flops_probed = False
        self._finalized = False
        self.registry.log_event("run", "start",
                                data={"out_dir": self.out_dir})

    def epoch_event(self, epoch: int, data: Optional[Dict[str, Any]] = None,
                    timing: Optional[Dict[str, Any]] = None) -> None:
        """One JSONL row per epoch: `data` deterministic (losses,
        counts), `timing` wall clock (fractions, rates)."""
        payload = {"epoch": int(epoch)}
        payload.update(data or {})
        self.registry.log_event("epoch", f"epoch_{int(epoch)}",
                                data=payload, timing=timing)

    def step_flops_once(self, step_fn, *args) -> Optional[float]:
        """The FLOPs of one train step of `step_fn` on `args`
        (train/train_step.step_cost_flops), probed at most once a
        session; later calls return the memo."""
        if not self._flops_probed:
            self._flops_probed = True
            from ..train.train_step import step_cost_flops
            self._flops_per_step = step_cost_flops(step_fn, *args)
        return self._flops_per_step

    @property
    def flops_probed(self) -> bool:
        return self._flops_probed

    def finalize(self) -> Dict[str, str]:
        """Write telemetry.jsonl (the event log), trace.json (Chrome
        trace) and metrics.prom (the registry's Prometheus text) under
        `out_dir`, and put the previous registry and recorder back;
        idempotent. Returns the paths."""
        if self._finalized:
            return {}
        self._finalized = True
        self.registry.log_event("run", "end")
        install_recorder(self._prev_recorder)
        set_registry(self._prev_registry)
        os.makedirs(self.out_dir, exist_ok=True)
        jsonl = os.path.join(self.out_dir, "telemetry.jsonl")
        trace = os.path.join(self.out_dir, "trace.json")
        prom = os.path.join(self.out_dir, "metrics.prom")
        self.registry.write_jsonl(jsonl)
        self.recorder.write(trace)
        with open(prom, "w") as f:
            f.write(self.registry.to_prometheus())
        return {"jsonl": jsonl, "chrome_trace": trace, "metrics": prom}


def start_session(config: TelemetryConfig,
                  run_dir: str) -> Optional[TelemetrySession]:
    """A live session when `config.enabled`, else None."""
    if not config.enabled:
        return None
    return TelemetrySession(config, run_dir)
