"""The elastic job's ledger, deterministic JSONL (counterpart:
hydragnn_tpu/elastic/ledger.py, whose records this keeps).

One record per supervisor event, split into a ``data`` bucket (a pure
function of the job spec, the fault plan and the children's
deterministic training) and a ``timing`` bucket (wall-clock durations).
Records are keyed by rank (``rank=-1`` for job-level events: generation
launches, coordinated aborts, restarts, the terminal state) and written
sorted by (rank, seq): rank exits land in wall-clock order, a race
between children, while each rank's own sequence and the job-level
sequence are deterministic.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

JOB = -1  # the rank id of job-level events


class JobLedger:
    """Per-rank event log with deterministic serialization.

    Carries no lock of its own: every write is serialized by the owning
    JobSupervisor's ``_lock`` (the run loop AND the cross-thread
    ``shutdown()`` terminal event both hold it around ``event()``) —
    external writers must do the same, and readers racing a live
    supervisor should snapshot via ``records()`` only between ticks."""

    def __init__(self):
        self._events: List[Dict[str, Any]] = []
        self._seq: Dict[int, int] = {}

    def event(self, rank: int, event: str,
              data: Optional[Dict[str, Any]] = None,
              timing: Optional[Dict[str, Any]] = None) -> None:
        seq = self._seq.get(rank, 0)
        self._seq[rank] = seq + 1
        rec: Dict[str, Any] = {"rank": int(rank), "seq": seq,
                               "event": str(event)}
        if data:
            rec["data"] = dict(data)
        if timing:
            rec["timing"] = dict(timing)
        self._events.append(rec)

    def records(self) -> List[Dict[str, Any]]:
        """Events sorted by (rank, seq) — the canonical ledger order."""
        return sorted(self._events, key=lambda r: (r["rank"], r["seq"]))

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
