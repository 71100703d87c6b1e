"""The trial ledger, deterministic JSONL (counterpart:
hydragnn_tpu/hpo/ledger.py, whose records this keeps).

One record per supervisor event. Each splits a ``data`` bucket (a pure
function of the trial specs, the fault plan and the children's
deterministic training: two identical chaos runs give identical
``data`` buckets) from a ``timing`` bucket (wall-clock durations, free
to differ run to run).

Records are collected in memory and written sorted by (trial, seq): with
concurrent trials the interleaving of events is a race between children,
while each trial's own sequence is deterministic.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


class TrialLedger:
    """Per-trial event log with deterministic serialization.

    Not thread-safe by design: the supervisor appends only from its
    single-threaded run loop (prune/shutdown requests are flags the loop
    acts on, so they never write here directly)."""

    def __init__(self):
        self._events: List[Dict[str, Any]] = []
        self._seq: Dict[int, int] = {}

    def event(self, trial_id: int, event: str,
              data: Optional[Dict[str, Any]] = None,
              timing: Optional[Dict[str, Any]] = None) -> None:
        seq = self._seq.get(trial_id, 0)
        self._seq[trial_id] = seq + 1
        rec: Dict[str, Any] = {"trial": int(trial_id), "seq": seq,
                               "event": str(event)}
        if data:
            rec["data"] = dict(data)
        if timing:
            rec["timing"] = dict(timing)
        self._events.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        """Events sorted by (trial, seq) — the canonical ledger order."""
        return sorted(self._events,
                      key=lambda r: (r["trial"], r["seq"]))

    def data_view(self) -> List[Dict[str, Any]]:
        """The deterministic projection: canonical order, timing
        stripped. Two identical chaos runs must compare equal here."""
        return [{k: v for k, v in rec.items() if k != "timing"}
                for rec in self.records()]

    def write(self, path: str) -> int:
        """Write the canonical-order JSONL; returns the record count."""
        recs = self.records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        return len(recs)
