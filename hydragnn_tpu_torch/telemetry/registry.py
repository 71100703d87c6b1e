"""Process-wide metrics registry: typed counters, gauges and histograms
with a structured JSONL event log and Prometheus text exposition
(counterpart: hydragnn_tpu/telemetry/registry.py, whose exposition and
event format this copy keeps byte for byte).

* ``to_prometheus()`` is the text format metrics stacks scrape; the
  serving engine's ``/metrics`` endpoint serves it (telemetry/http.py).
* ``events`` / ``write_jsonl()`` is a run's event log. An event keeps its
  deterministic payload (``data``: counts, steps) apart from its
  wall-clock payload (``timing``), so two identical runs give identical
  JSONL apart from ``ts`` and ``timing``.

The first report of a name pins its kind; reporting it as another kind
raises. Names are sanitized to the Prometheus charset on export only.
One lock per registry, O(1) updates inside it; every report site is a
cold path (a farm run, a structure request, a scrape).
"""
from __future__ import annotations

import json
import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# default histogram bucket boundaries (seconds-flavored exponential ladder;
# override per metric at first observe)
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")


def _sanitize(name: str, label: bool = False) -> str:
    pat = _LABEL_RE if label else _NAME_RE
    out = pat.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label_value(value: str) -> str:
    """Prometheus 0.0.4 label-value escaping (backslash, quote, newline)
    — a dynamic label like reason=str(exc) must never produce a line the
    scraper rejects (it would discard the whole exposition page)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP text escaping per the exposition format (backslash, newline)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


class MetricTypeError(TypeError):
    """A metric name was reported under two different kinds."""


class _Histogram:
    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)  # +inf bucket last
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.total += value
        self.count += 1
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class MetricsRegistry:
    """Thread-safe metric store. Keys are (name, sorted label tuple)."""

    def __init__(self):
        # all four stores are lock-guarded
        self._lock = threading.Lock()
        self._kinds: Dict[str, str] = {}  # guarded-by: _lock
        self._help: Dict[str, str] = {}  # guarded-by: _lock
        self._values: Dict[  # guarded-by: _lock
            Tuple[str, Tuple[Tuple[str, str], ...]], Any] = {}
        self._events: List[Dict[str, Any]] = []  # guarded-by: _lock

    # ------------------------------------------------------------ reporting

    def _key(self, name: str, labels: Dict[str, str]
             ) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
        return (name, tuple(sorted((str(k), str(v))
                                   for k, v in labels.items())))

    # only called from the report methods' critical sections
    # holds-lock: _lock
    def _register(self, name: str, kind: str, help_text: str) -> None:
        have = self._kinds.get(name)
        if have is None:
            self._kinds[name] = kind
            if help_text:
                self._help[name] = help_text
        elif have != kind:
            raise MetricTypeError(
                f"metric {name!r} already registered as {have}, "
                f"cannot report it as {kind}")

    def counter_inc(self, name: str, value: float = 1.0, *,
                    help: str = "", **labels) -> None:
        """Monotonic counter; `value` must be >= 0."""
        if value < 0:
            raise ValueError(f"counter {name!r} increment must be >= 0, "
                             f"got {value}")
        with self._lock:
            self._register(name, COUNTER, help)
            k = self._key(name, labels)
            self._values[k] = self._values.get(k, 0.0) + value

    def gauge_set(self, name: str, value: float, *, help: str = "",
                  **labels) -> None:
        """Point-in-time gauge (last write wins)."""
        with self._lock:
            self._register(name, GAUGE, help)
            self._values[self._key(name, labels)] = float(value)

    def histogram_observe(self, name: str, value: float, *,
                          buckets: Sequence[float] = DEFAULT_BUCKETS,
                          help: str = "", **labels) -> None:
        """Cumulative histogram; bucket boundaries pin at first observe."""
        with self._lock:
            self._register(name, HISTOGRAM, help)
            k = self._key(name, labels)
            h = self._values.get(k)
            if h is None:
                h = self._values[k] = _Histogram(buckets)
            h.observe(float(value))

    # ------------------------------------------------------------ event log

    def log_event(self, kind: str, name: str,
                  data: Optional[Dict[str, Any]] = None,
                  timing: Optional[Dict[str, Any]] = None) -> None:
        """Append one structured event. `data` holds the deterministic
        payload (identical across identical runs); `timing` holds
        wall-clock-derived values — the JSONL determinism contract
        compares events with `ts` and `timing` stripped."""
        evt: Dict[str, Any] = {"ts": time.time(), "kind": str(kind),
                               "name": str(name)}
        if data:
            evt["data"] = dict(data)
        if timing:
            evt["timing"] = dict(timing)
        with self._lock:
            self._events.append(evt)

    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    # -------------------------------------------------------------- exports

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """{name: {"kind", "values": {label_tuple: value}}} — histograms as
        {"sum", "count", "buckets": [(le, n), ...]}."""
        with self._lock:
            out: Dict[str, Dict[str, Any]] = {}
            for (name, labels), val in self._values.items():
                m = out.setdefault(name, {"kind": self._kinds[name],
                                          "values": {}})
                if isinstance(val, _Histogram):
                    m["values"][labels] = {
                        "sum": val.total, "count": val.count,
                        "buckets": list(zip(
                            list(val.buckets) + [float("inf")], val.counts)),
                    }
                else:
                    m["values"][labels] = val
            return out

    def to_prometheus(self, prefix: str = "hydragnn_") -> str:
        """Prometheus text exposition (0.0.4). Names/labels sanitized to
        the legal charset; histogram export uses the standard
        _bucket/_sum/_count triple with cumulative `le` counts."""
        snap = self.snapshot()
        with self._lock:
            helps = dict(self._help)
        lines: List[str] = []
        for name in sorted(snap):
            kind = snap[name]["kind"]
            pname = _sanitize(prefix + name)
            if name in helps:
                lines.append(f"# HELP {pname} {_escape_help(helps[name])}")
            lines.append(f"# TYPE {pname} {kind}")
            for labels, val in sorted(snap[name]["values"].items()):
                lab = ",".join(
                    f'{_sanitize(k, label=True)}='
                    f'"{_escape_label_value(v)}"' for k, v in labels)
                if kind == HISTOGRAM:
                    cum = 0
                    for le, n in val["buckets"]:
                        cum += n
                        le_s = "+Inf" if le == float("inf") else repr(le)
                        blab = (lab + "," if lab else "") + f'le="{le_s}"'
                        lines.append(f"{pname}_bucket{{{blab}}} {cum}")
                    suffix = f"{{{lab}}}" if lab else ""
                    lines.append(f"{pname}_sum{suffix} {val['sum']}")
                    lines.append(f"{pname}_count{suffix} {val['count']}")
                else:
                    suffix = f"{{{lab}}}" if lab else ""
                    lines.append(f"{pname}{suffix} {val}")
        return "\n".join(lines) + "\n"

    def write_jsonl(self, path: str) -> int:
        """Write the event log as one JSON object per line; returns the
        number of events written."""
        events = self.events
        with open(path, "w") as f:
            for evt in events:
                f.write(json.dumps(evt, sort_keys=True) + "\n")
        return len(events)

    def clear(self) -> None:
        with self._lock:
            self._kinds.clear()
            self._help.clear()
            self._values.clear()
            self._events.clear()

    def _copy_state(self):
        """Deep-copied (kinds, help, values) under the lock — histograms
        are cloned so the copy cannot alias live bucket lists."""
        with self._lock:
            values = {}
            for k, v in self._values.items():
                if isinstance(v, _Histogram):
                    h = _Histogram(v.buckets)
                    h.counts = list(v.counts)
                    h.total = v.total
                    h.count = v.count
                    values[k] = h
                else:
                    values[k] = v
            return dict(self._kinds), dict(self._help), values

    def seed_from(self, other: "MetricsRegistry") -> None:
        """Seed this (fresh, run-scoped) registry with another registry's
        current metric state, not its events; entries already in `self`
        win on conflict."""
        kinds, helps, values = other._copy_state()
        with self._lock:
            for name, kind in kinds.items():
                self._kinds.setdefault(name, kind)
            for name, text in helps.items():
                self._help.setdefault(name, text)
            for key, val in values.items():
                self._values.setdefault(key, val)


# ------------------------------------------------------------------ global --
# One process-wide registry: cold-path call sites report unconditionally
# (a dict update under a lock), and `set_registry` swaps in a fresh one
# for a run-scoped export.

_GLOBAL = MetricsRegistry()
_GLOBAL_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    return _GLOBAL


def set_registry(reg: Optional[MetricsRegistry]) -> MetricsRegistry:
    """Install `reg` as the process registry (None -> fresh one); returns
    the previous registry so sessions can restore it."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        prev = _GLOBAL
        _GLOBAL = reg if reg is not None else MetricsRegistry()
        return prev
