"""Span tracing: Chrome trace-event JSON for the serving and MD
timelines, and the opt-in `torch.profiler` device-trace bracket
(counterpart: hydragnn_tpu/telemetry/spans.py; its recorder and the
module-level helpers are copied, and `device_trace` / `EpochDeviceTrace`
bracket `torch.profiler` where JAX's bracket `jax.profiler`).

The registry (telemetry/registry.py) says how much and how often; spans
say when, on which thread and overlapping what. One recorder collects
complete events (`ph: "X"`) with microsecond timestamps on one clock
and the recording thread's id; the export (`{"traceEvents": [...]}`)
loads in Perfetto or chrome://tracing.

Off by default: with no recorder installed, `record` / `span` are one
global read and a None check, so per-request call sites cost nanoseconds.
Call sites use these helpers, not a held recorder, so installing or
removing one flips every producer at once.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

# trace-event timestamps are microseconds on one shared clock: monotonic
# and high-resolution (absolute wall time goes in the JSONL instead)
_CLOCK = time.perf_counter


# default retained-event cap: at ~200 bytes an event about 200 MB, a
# hard stop against a long run exhausting the host
DEFAULT_MAX_EVENTS = 1_000_000


class SpanRecorder:
    """Collects Chrome trace events in memory; thread-safe appends.

    Bounded: past `max_events` spans the recorder drops new events and
    counts them (`dropped`); the exported trace carries the count as an
    instant event, so a truncation is visible."""

    def __init__(self, process_name: str = "hydragnn",
                 max_events: int = DEFAULT_MAX_EVENTS):
        self._lock = threading.Lock()
        self.events: List[Dict[str, Any]] = []
        self.max_events = int(max_events)
        self.dropped = 0
        self.pid = os.getpid()
        self._t0 = _CLOCK()
        # process metadata event so Perfetto names the track
        self.events.append({
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "args": {"name": process_name},
        })

    def _append(self, evt: Dict[str, Any]) -> None:
        with self._lock:
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(evt)

    def add(self, name: str, t_start: float, dur_s: float,
            cat: str = "host", args: Optional[Dict[str, Any]] = None
            ) -> None:
        """One complete event; `t_start` is a _CLOCK() reading."""
        evt: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": "X",
            "ts": (t_start - self._t0) * 1e6,
            "dur": max(dur_s, 0.0) * 1e6,
            "pid": self.pid, "tid": threading.get_ident(),
        }
        if args:
            evt["args"] = dict(args)
        self._append(evt)

    def instant(self, name: str, cat: str = "host",
                args: Optional[Dict[str, Any]] = None) -> None:
        evt: Dict[str, Any] = {
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": (_CLOCK() - self._t0) * 1e6,
            "pid": self.pid, "tid": threading.get_ident(),
        }
        if args:
            evt["args"] = dict(args)
        self._append(evt)

    def chrome_trace(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self.events)
            dropped = self.dropped
        if dropped:
            events.append({
                "name": f"spans_dropped_at_cap: {dropped}",
                "ph": "i", "s": "g",
                "ts": (_CLOCK() - self._t0) * 1e6,
                "pid": self.pid, "tid": 0,
                "args": {"dropped": dropped,
                         "max_events": self.max_events},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the event count."""
        trace = self.chrome_trace()
        with open(path, "w") as f:
            json.dump(trace, f)
        return len(trace["traceEvents"])


# ------------------------------------------------------------------ global --

_RECORDER: Optional[SpanRecorder] = None


def install_recorder(rec: Optional[SpanRecorder]) -> Optional[SpanRecorder]:
    """Install the process span recorder (None = disable); returns the
    previous one."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = rec
    return prev


def current_recorder() -> Optional[SpanRecorder]:
    return _RECORDER


def enabled() -> bool:
    return _RECORDER is not None


def record(name: str, t_start: float, dur_s: float, cat: str = "host",
           **args) -> None:
    """Record a completed span from explicit timings. Off, it is one
    global read and a None check."""
    rec = _RECORDER
    if rec is not None:
        rec.add(name, t_start, dur_s, cat, args or None)


@contextlib.contextmanager
def span(name: str, cat: str = "host", **args):
    """A span around a host region; near-free with no recorder."""
    rec = _RECORDER
    if rec is None:
        yield
        return
    t0 = _CLOCK()
    try:
        yield
    finally:
        rec.add(name, t0, _CLOCK() - t0, cat, args or None)


def now() -> float:
    """The span clock, for spans whose start predates the call site (the
    serving queue wait, measured from submit time)."""
    return _CLOCK()


# ------------------------------------------------------- device-side traces --


def _profiler_activities():
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _export(prof, log_dir: str) -> None:
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        log_dir, f"torch_trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Opt-in `torch.profiler` capture of a region (host ops and, with a
    card, its kernels), written as a Chrome trace under `log_dir`.
    Heavyweight: it holds the trace buffers for the whole region."""
    import torch
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_profiler_activities())
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        _export(prof, log_dir)


class EpochDeviceTrace:
    """Epoch-targeted device trace: entered around each epoch, it
    captures a `torch.profiler` trace of exactly the target epoch under
    <prefix>/profile/ (the `Profile` config section's `enable` and
    `target_epoch`)."""

    def __init__(self, prefix: str = "", enable: bool = False,
                 target_epoch: int = 0):
        self.prefix = prefix
        self.enable = enable
        self.target_epoch = target_epoch
        self.current_epoch = -1
        self.done = False
        self._prof = None

    def setup(self, config) -> None:
        """The `Profile` section: `enable` 0/1 and `target_epoch`."""
        self.enable = int(config.get("enable", 0)) == 1
        self.target_epoch = int(config.get("target_epoch", 0))

    def set_current_epoch(self, current_epoch: int) -> None:
        self.current_epoch = current_epoch

    def __enter__(self):
        if self.enable and not self.done \
                and self.current_epoch == self.target_epoch:
            import torch
            self._prof = torch.profiler.profile(
                activities=_profiler_activities())
            self._prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._prof is not None:
            prof, self._prof = self._prof, None
            prof.__exit__(None, None, None)
            _export(prof, os.path.join(self.prefix or ".", "profile"))
            self.done = True
        return False
