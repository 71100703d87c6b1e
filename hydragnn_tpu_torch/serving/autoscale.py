"""Fleet autoscaling on queue depth or tail latency (counterpart:
hydragnn_tpu/serving/autoscale.py).

``QueueDepthAutoscaler`` reads the router's health snapshot and, on
sustained pressure, grows or shrinks the fleet:

* **signal**: the mean queue depth over the live replicas with a live
  dispatcher; at or above ``high_depth`` with room under
  ``max_replicas`` it scales up, at or below ``low_depth`` with slack
  above ``min_replicas`` it scales down, with ``cooldown_s`` between two
  actions. With ``signal="p99_latency"`` the watermarks are
  ``high_p99_ms`` / ``low_p99_ms`` against the fleet-wide p99 of
  ``router.stats()``; a window with no resolved request takes no action.
* **scale-up warms from the store**: a retired slot is revived first
  (``router.restart_replica``), else ``router.add_replica`` appends one;
  either way the engine installs its kernels from the shared compile
  store (no ``nvcc``), captures its graphs, and joins on the fleet's
  published version.
* **scale-down drains**: ``router.retire_replica`` takes the
  highest-index live replica out of rotation, waits for its queue to
  empty, then shuts it down (its graphs go with its dispatcher); a drain
  past its bound re-admits the replica and a later tick retries.
* **a canary freezes scaling**: while the CheckpointPublisher owns a
  replica every decision is skipped (``skipped_canary``).

Lock discipline: counters and events are guarded by the scaler's lock;
router calls and the poll wait run outside it. The knobs come from
serving/config.resolve_autoscale, read by the caller.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

from ..telemetry.registry import get_registry
from .config import AutoscaleConfig

_log = logging.getLogger("hydragnn_tpu_torch")


class QueueDepthAutoscaler:
    """Single-writer fleet scaler over a ReplicaRouter (the module
    docstring gives the policy). Synchronous use: ``step()`` evaluates
    one decision (returns the event dict, or None). Background use:
    ``start()`` polls every ``cfg.poll_interval_s`` until ``stop()``.
    One autoscaler per router — ``add_replica`` is documented
    single-writer."""

    def __init__(self, router, *,
                 config: Optional[AutoscaleConfig] = None):
        self.router = router
        self.cfg = config if config is not None else AutoscaleConfig()
        if self.cfg.min_replicas < 1:
            raise ValueError(
                f"min_replicas={self.cfg.min_replicas!r} must be >= 1 — "
                "a fleet scaled to zero cannot serve")
        if self.cfg.max_replicas < self.cfg.min_replicas:
            raise ValueError(
                f"max_replicas={self.cfg.max_replicas!r} < min_replicas="
                f"{self.cfg.min_replicas!r}")
        self._lock = threading.Lock()
        self.scale_up_count = 0  # guarded-by: _lock
        self.scale_down_count = 0  # guarded-by: _lock
        self.skipped_canary = 0  # guarded-by: _lock — ticks skipped
        #   because a publish adjudication owned a replica
        self.events: List[dict] = []  # guarded-by: _lock — ordered
        #   scale actions
        self._last_action_t: Optional[float] = None  # guarded-by: _lock
        self._t0 = time.monotonic()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _run():
            while not self._stop.is_set():
                try:
                    self.step()
                except Exception:  # noqa: BLE001 — a transient router
                    # error must not kill the scaling loop
                    _log.warning("autoscaler step failed", exc_info=True)
                self._stop.wait(self.cfg.poll_interval_s)

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=60)

    def snapshot(self) -> dict:
        with self._lock:
            return {"scale_up_count": self.scale_up_count,
                    "scale_down_count": self.scale_down_count,
                    "skipped_canary": self.skipped_canary,
                    "events": [dict(e) for e in self.events]}

    # -------------------------------------------------------------- decision

    def step(self) -> Optional[dict]:
        """Evaluate one scaling decision against the current health
        snapshot. Returns the recorded event dict when an action was
        taken, else None."""
        cfg = self.cfg
        health = self.router.health()
        if health["state"] == "shutdown":
            return None
        reps = health["replicas"]
        if any(h.get("canary") for h in reps.values()):
            with self._lock:
                self.skipped_canary += 1
            return None
        live = [h for h in reps.values() if h["alive"]]
        n_live = len(live)
        if cfg.signal == "p99_latency":
            stats = self.router.stats()
            if not stats.get("count"):
                return None  # no resolved requests in the window —
                # p99 is the zeroed placeholder, not a fast fleet
            signal = float(stats["p99_ms"])
            high, low = cfg.high_p99_ms, cfg.low_p99_ms
        else:
            depths = [float(h["queue_depth"]) for h in live
                      if h["dispatcher_alive"]]
            signal = sum(depths) / len(depths) if depths else 0.0
            high, low = cfg.high_depth, cfg.low_depth
        now = time.monotonic()
        with self._lock:
            cooling = (self._last_action_t is not None
                       and now - self._last_action_t < cfg.cooldown_s)
        if cooling:
            return None
        if signal >= high and n_live < cfg.max_replicas:
            return self._scale_up(reps, signal, n_live)
        if signal <= low and n_live > cfg.min_replicas:
            return self._scale_down(reps, signal, n_live)
        return None

    def _scale_up(self, reps: dict, signal_val: float,
                  n_live: int) -> Optional[dict]:
        # prefer reviving a retired slot (restart_replica) over growing
        # the replica list — both are disk-warm, the former keeps
        # indices dense
        retired = sorted(int(i) for i, h in reps.items()
                         if h.get("retired"))
        try:
            if retired:
                report = self.router.restart_replica(retired[0])
            else:
                report = self.router.add_replica()
        except (RuntimeError, ValueError) as exc:
            _log.warning("autoscale scale-up failed: %s", exc)
            return None
        event = {"action": "scale_up", "replica": report["replica"],
                 "revived": bool(retired), "signal": self.cfg.signal,
                 "avg_depth": signal_val,  # historical key: the signal
                 # value (mean depth, or p99 ms in p99_latency mode)
                 "replicas_before": n_live,
                 "replicas_after": n_live + 1,
                 "fresh_compiles": report.get("fresh", 0),
                 "warmup_s": report.get("warmup_s", 0.0),
                 "t_s": round(time.monotonic() - self._t0, 3)}
        with self._lock:
            self.scale_up_count += 1
            self.events.append(event)
            self._last_action_t = time.monotonic()
        self._count("scale_up")
        return event

    def _scale_down(self, reps: dict, signal_val: float,
                    n_live: int) -> Optional[dict]:
        # retire the HIGHEST-index live replica: lowest indices carry
        # the `_pick` tie-break traffic, and dense-from-zero slots keep
        # revival deterministic
        victims = sorted((int(i) for i, h in reps.items()
                          if h["alive"] and not h.get("canary")),
                         reverse=True)
        if not victims:
            return None
        victim = victims[0]
        try:
            self.router.retire_replica(
                victim, timeout_s=self.cfg.drain_timeout_s)
        except (TimeoutError, ValueError) as exc:
            # drain outlived its bound (the replica was re-admitted) or
            # state changed under us — retry on a later tick
            _log.warning("autoscale scale-down of replica %d skipped: %s",
                         victim, exc)
            return None
        event = {"action": "scale_down", "replica": victim,
                 "signal": self.cfg.signal, "avg_depth": signal_val,
                 "replicas_before": n_live,
                 "replicas_after": n_live - 1,
                 "t_s": round(time.monotonic() - self._t0, 3)}
        with self._lock:
            self.scale_down_count += 1
            self.events.append(event)
            self._last_action_t = time.monotonic()
        self._count("scale_down")
        return event

    @staticmethod
    def _count(action: str) -> None:
        get_registry().counter_inc(
            "serve.autoscale_total",
            help="autoscaler actions by direction",
            action=action)
