"""Checkpoint publisher: a trainer's BEST checkpoints into the live
fleet, canaried (counterpart: hydragnn_tpu/serving/publish.py).

``CheckpointPublisher`` polls the BEST marker of a run
(utils/checkpoint.py), takes a save only once it is COMMITTED, and rolls
each new candidate into a ``ReplicaRouter``:

1. one replica leaves the primary rotation as the canary
   (``router.set_canary``) and swaps to the candidate
   (``router.swap_one``: drained, version-tagged);
2. every k-th request is mirrored to it (``router.install_mirror``); the
   shadow copy never touches the primary future;
3. the window of mirrored pairs is adjudicated (``adjudicate_window``):
   the worst relative drift of the candidate's outputs from the
   incumbent's on the same requests (``pair_rel_err``: a non-finite or
   misshapen output is infinite drift), no shadow failure, and the
   candidate's p99 within a factor of the incumbent's;
4. promote (the canary rejoins the rotation first, then the other
   replicas swap one at a time) or roll back (the canary swaps back while
   still out of rotation, and the version is quarantined so a later poll
   skips it).

A promote that fails part way rolls every replica already on the
candidate back to the incumbent, so the fleet ends on one version; every
move goes through a drain, so no future is lost. A mid-write save is
counted (``skipped_uncommitted``) and retried at the next poll.

Lock discipline: the counters and history are guarded by the publisher's
lock; the window wait and every router call run outside it. The knobs
come from serving/config.resolve_publish, read by the caller.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from ..telemetry.registry import get_registry
from ..utils.checkpoint import (load_best_model, marker_target,
                                verify_checkpoint)
from ..utils.profiling import latency_percentiles
from ..utils.weights import export_jax_variables
from .config import PublishConfig

_log = logging.getLogger("hydragnn_tpu_torch")


def _leaves(tree) -> List[Any]:
    """A result tree's leaves in the JAX package's tree order: lists and
    tuples in order, mappings by sorted key, None empty."""
    if tree is None:
        return []
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def pair_rel_err(incumbent_result, candidate_result) -> float:
    """The worst relative elementwise drift of a candidate's outputs from
    the incumbent's on the same request; a non-finite candidate value, a
    shape mismatch or a tree mismatch is inf."""
    inc = _leaves(incumbent_result)
    cand = _leaves(candidate_result)
    if len(inc) != len(cand):
        return float("inf")
    worst = 0.0
    for x, y in zip(inc, cand):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if x.shape != y.shape:
            return float("inf")
        if not np.all(np.isfinite(y)):
            return float("inf")
        if x.size == 0:
            continue
        denom = np.maximum(np.abs(x), 1e-8)
        worst = max(worst, float(np.max(np.abs(x - y) / denom)))
    return worst


def adjudicate_window(pairs: List[dict], shadow_failures: int,
                      cfg: PublishConfig) -> dict:
    """The canary's verdict over its window of pairs (``err``,
    ``primary_ms``, ``shadow_ms``): ``enough`` (at least
    ``cfg.min_pairs``), ``error_ok`` (worst drift within
    ``cfg.max_rel_err`` and no shadow failure) and ``latency_ok``
    (candidate p99 <= ``cfg.latency_factor`` * max(incumbent p99,
    ``cfg.latency_floor_ms``)); ``promote`` needs all three."""
    max_err = max((p["err"] for p in pairs), default=0.0)
    inc_p99 = latency_percentiles(
        [p["primary_ms"] / 1000.0 for p in pairs]).get("p99_ms", 0.0)
    cand_p99 = latency_percentiles(
        [p["shadow_ms"] / 1000.0 for p in pairs]).get("p99_ms", 0.0)
    budget_ms = cfg.latency_factor * max(inc_p99, cfg.latency_floor_ms)
    enough = len(pairs) >= cfg.min_pairs
    error_ok = max_err <= cfg.max_rel_err and shadow_failures == 0
    latency_ok = cand_p99 <= budget_ms
    return {"pairs": len(pairs), "shadow_failures": int(shadow_failures),
            "max_rel_err": max_err, "incumbent_p99_ms": inc_p99,
            "candidate_p99_ms": cand_p99, "latency_budget_ms": budget_ms,
            "enough": enough, "error_ok": error_ok,
            "latency_ok": latency_ok,
            "promote": enough and error_ok and latency_ok}


class _ShadowWindow:
    """Mirrored (primary, shadow) pairs, collected by the futures'
    callbacks on the engines' dispatcher threads; the drift is computed
    outside the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._open: Dict[int, dict] = {}  # guarded-by: _lock
        self._next_id = 0  # guarded-by: _lock
        self.pairs: List[dict] = []  # guarded-by: _lock
        self.shadow_failures = 0  # guarded-by: _lock
        self.primary_failures = 0  # guarded-by: _lock

    def on_pair(self, primary: Future, shadow: Future) -> None:
        with self._lock:
            pid = self._next_id
            self._next_id += 1
            self._open[pid] = {"t0": time.monotonic()}
        primary.add_done_callback(
            lambda f, pid=pid: self._done(pid, "primary", f))
        shadow.add_done_callback(
            lambda f, pid=pid: self._done(pid, "shadow", f))

    def _done(self, pid: int, side: str, fut: Future) -> None:
        exc = fut.exception()
        value = None if exc is not None else fut.result()
        now = time.monotonic()
        ready = None
        with self._lock:
            rec = self._open.get(pid)
            if rec is None:
                return
            rec[side] = (exc, value)
            rec[f"{side}_ms"] = (now - rec["t0"]) * 1000.0
            if "primary" in rec and "shadow" in rec:
                ready = self._open.pop(pid)
        if ready is None:
            return
        p_exc, p_val = ready["primary"]
        s_exc, s_val = ready["shadow"]
        if p_exc is not None:
            # the incumbent failed this request: no signal either way
            with self._lock:
                self.primary_failures += 1
            return
        if s_exc is not None:
            with self._lock:
                self.shadow_failures += 1
            return
        err = pair_rel_err(p_val, s_val)
        with self._lock:
            self.pairs.append({"err": err,
                               "primary_ms": ready["primary_ms"],
                               "shadow_ms": ready["shadow_ms"]})

    def snapshot(self):
        with self._lock:
            return list(self.pairs), self.shadow_failures

    def count(self) -> int:
        with self._lock:
            return len(self.pairs)


class CheckpointPublisher:
    """Canaries each new BEST checkpoint of run `log_name` (under `path`)
    into `router`'s fleet. `state_template` is a TrainState of the served
    architecture (the restore template); `incumbent_variables` (a Flax
    tree, as `swap_variables` takes) and `incumbent_version` are what a
    rollback restores, and a promoted candidate becomes the incumbent.

    ``poll_once()`` detects and publishes one candidate (its outcome, or
    None); ``start()`` polls every ``cfg.poll_interval_s`` on a thread
    until ``stop()``."""

    def __init__(self, router, state_template, log_name: str,
                 path: str = "./logs", *,
                 incumbent_variables, incumbent_version: str = "v0",
                 config: Optional[PublishConfig] = None):
        self.router = router
        self._template = state_template
        self.log_name = str(log_name)
        self.path = str(path)
        self.cfg = config if config is not None else PublishConfig()
        self._lock = threading.Lock()
        # (variables, version) a rollback restores
        self._incumbent = (incumbent_variables,
                           str(incumbent_version))  # guarded-by: _lock
        self.last_step = -1  # guarded-by: _lock
        self.publish_count = 0  # guarded-by: _lock
        self.promote_count = 0  # guarded-by: _lock
        self.rollback_count = 0  # guarded-by: _lock
        self.skipped_uncommitted = 0  # guarded-by: _lock
        self.history: List[dict] = []  # guarded-by: _lock
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
                    self.poll_once()
                except Exception:  # noqa: BLE001 — the watch loop must
                    # survive a transient filesystem or router error
                    _log.warning("checkpoint publisher poll failed",
                                 exc_info=True)
                self._stop.wait(self.cfg.poll_interval_s)

        self._thread = threading.Thread(target=_run, daemon=True,
                                        name="ckpt-publisher")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=60)

    def snapshot(self) -> dict:
        with self._lock:
            return {"incumbent_version": self._incumbent[1],
                    "last_step": self.last_step,
                    "publish_count": self.publish_count,
                    "promote_count": self.promote_count,
                    "rollback_count": self.rollback_count,
                    "skipped_uncommitted": self.skipped_uncommitted,
                    "history": [dict(e) for e in self.history]}

    # ------------------------------------------------------------- detection

    def poll_once(self) -> Optional[dict]:
        """Read the BEST marker; skip an uncommitted, already seen or
        quarantined candidate, else restore and publish it. Returns the
        outcome, or None when nothing rolled."""
        target = marker_target(self.log_name, path=self.path,
                               which="best")
        if target is None:
            return None
        if not verify_checkpoint(target):
            # a save in flight: counted and retried (last_step stays)
            with self._lock:
                self.skipped_uncommitted += 1
            return None
        base = os.path.basename(target)
        try:
            step = int(base.split("_")[-1])
        except ValueError:
            return None
        with self._lock:
            if step <= self.last_step:
                return None
        version = f"best:step_{step}"
        if version in self.router.quarantined_versions():
            with self._lock:
                self.last_step = max(self.last_step, step)
            self._event("skipped_quarantined", version, step=step)
            return None
        state = load_best_model(self._template, self.log_name,
                                path=self.path)
        if state is None:
            # gone, or failed the deep verify since: retry next poll
            with self._lock:
                self.skipped_uncommitted += 1
            return None
        with self._lock:
            self.last_step = max(self.last_step, step)
        return self.publish(export_jax_variables(state), version)

    # ------------------------------------------------------------ publishing

    def publish(self, variables, version: str) -> dict:
        """One canary adjudication of `variables` / `version` against the
        incumbent; blocks until the outcome (``action``: promoted,
        rolled_back or aborted)."""
        version = str(version)
        cfg = self.cfg
        with self._lock:
            incumbent_vars, incumbent_version = self._incumbent
            self.publish_count += 1
        health = self.router.health()
        routable = sorted(
            int(i) for i, h in health["replicas"].items()
            if h["alive"] and not h["draining"] and not h["retired"]
            and h["dispatcher_alive"])
        if len(routable) < 2:
            return self._publish_direct(variables, version,
                                        incumbent_version)
        # the highest index canaries: ties in _pick prefer low indices,
        # so it carries the least primary traffic
        canary = routable[-1]
        self._event("canary_start", version, replica=canary,
                    incumbent=incumbent_version)
        self.router.set_canary(canary, True)
        try:
            self.router.swap_one(canary, variables, version)
        except Exception as exc:  # noqa: BLE001 — the canary still serves
            # the incumbent (swap_variables fails before any change)
            self.router.set_canary(canary, False)
            self.router.quarantine_version(
                version, f"canary swap failed: {type(exc).__name__}")
            with self._lock:
                self.rollback_count += 1
            self._event("rolled_back", version, replica=canary,
                        reason=f"canary swap failed: {exc}")
            self._count("rolled_back")
            return {"action": "rolled_back", "version": version,
                    "reason": f"canary swap failed: {exc}"}
        window = _ShadowWindow()
        self.router.install_mirror(canary, cfg.mirror_every,
                                   window.on_pair)
        deadline = time.monotonic() + cfg.window_timeout_s
        while time.monotonic() < deadline:
            if window.count() >= cfg.window_pairs:
                break
            time.sleep(0.005)
        self.router.remove_mirror()
        pairs, shadow_failures = window.snapshot()
        verdict = adjudicate_window(pairs, shadow_failures, cfg)
        if verdict["promote"]:
            return self._promote(canary, variables, version,
                                 incumbent_vars, incumbent_version,
                                 verdict)
        return self._roll_back(canary, variables, version,
                               incumbent_vars, incumbent_version,
                               verdict)

    def _publish_direct(self, variables, version: str,
                        incumbent_version: str) -> dict:
        """A fleet of one routable replica cannot spare a canary: a plain
        hot_swap, whose failure quarantines the candidate."""
        try:
            self.router.hot_swap(variables, version)
        except Exception as exc:  # noqa: BLE001
            self.router.quarantine_version(
                version, f"direct swap failed: {type(exc).__name__}")
            with self._lock:
                self.rollback_count += 1
            self._event("rolled_back", version,
                        reason=f"direct swap failed: {exc}")
            self._count("rolled_back")
            return {"action": "rolled_back", "version": version,
                    "reason": f"direct swap failed: {exc}"}
        with self._lock:
            self._incumbent = (variables, version)
            self.promote_count += 1
        self._event("promoted", version, mode="direct",
                    incumbent=incumbent_version)
        self._count("promoted")
        return {"action": "promoted", "version": version,
                "mode": "direct"}

    def _promote(self, canary: int, variables, version: str,
                 incumbent_vars, incumbent_version: str,
                 verdict: dict) -> dict:
        # the canary rejoins the rotation first: rolling the others
        # drains them one at a time, and a fleet of two would otherwise
        # have nothing routable
        self.router.set_canary(canary, False)
        health = self.router.health()
        failed = None
        for idx in sorted(int(i) for i in health["replicas"]):
            h = health["replicas"][str(idx)]
            if idx == canary or not h["alive"] or h["retired"]:
                continue
            try:
                self.router.swap_one(idx, variables, version)
            except Exception as exc:  # noqa: BLE001
                # a replica that died or retired meanwhile is no failure
                now = self.router.health()["replicas"].get(str(idx))
                if now is None or not now["alive"]:
                    continue
                failed = (idx, exc)
                break
        if failed is not None:
            idx, exc = failed
            self._restore_incumbent(incumbent_vars, incumbent_version,
                                    version)
            self.router.quarantine_version(
                version, f"promote failed on replica {idx}: "
                         f"{type(exc).__name__}")
            with self._lock:
                self.rollback_count += 1
            self._event("rolled_back", version, replica=idx,
                        reason=f"promote failed on replica {idx}: {exc}",
                        verdict=verdict)
            self._count("rolled_back")
            return {"action": "rolled_back", "version": version,
                    "reason": f"promote failed on replica {idx}: {exc}",
                    "verdict": verdict}
        self.router.record_published(variables, version)
        with self._lock:
            self._incumbent = (variables, version)
            self.promote_count += 1
        self._event("promoted", version, replica=canary,
                    incumbent=incumbent_version, verdict=verdict)
        self._count("promoted")
        return {"action": "promoted", "version": version,
                "verdict": verdict}

    def _roll_back(self, canary: int, variables, version: str,
                   incumbent_vars, incumbent_version: str,
                   verdict: dict) -> dict:
        """A failed or starved window: the canary swaps back to the
        incumbent while still out of rotation, then rejoins. A starved
        window (too few pairs) aborts without quarantine, so a later poll
        may retry the candidate."""
        starved = not verdict["enough"]
        rollback_error = None
        try:
            self.router.swap_one(canary, incumbent_vars,
                                 incumbent_version)
        except Exception as exc:  # noqa: BLE001 — the canary still holds
            # the candidate: a restart rebuilds it on the incumbent
            rollback_error = f"{type(exc).__name__}: {exc}"
            self.router.restart_replica(canary)
        self.router.set_canary(canary, False)
        if starved:
            with self._lock:
                self.last_step = -1 if self.last_step < 0 \
                    else self.last_step - 1
            self._event("aborted", version, replica=canary,
                        verdict=verdict, rollback_error=rollback_error)
            self._count("aborted")
            return {"action": "aborted", "version": version,
                    "verdict": verdict}
        self.router.quarantine_version(
            version,
            f"canary adjudication failed: max_rel_err="
            f"{verdict['max_rel_err']:.3g} (bound "
            f"{self.cfg.max_rel_err:.3g}), candidate p99 "
            f"{verdict['candidate_p99_ms']:.1f} ms (budget "
            f"{verdict['latency_budget_ms']:.1f} ms), "
            f"{verdict['shadow_failures']} shadow failures")
        with self._lock:
            self.rollback_count += 1
        self._event("rolled_back", version, replica=canary,
                    verdict=verdict, rollback_error=rollback_error)
        self._count("rolled_back")
        return {"action": "rolled_back", "version": version,
                "verdict": verdict}

    def _restore_incumbent(self, incumbent_vars, incumbent_version: str,
                           candidate_version: str) -> None:
        """Every replica on the candidate back to the incumbent (a
        replica whose swap-back fails is restarted from the factory)."""
        self.router.record_published(incumbent_vars, incumbent_version)
        health = self.router.health()
        for idx in sorted(int(i) for i in health["replicas"]):
            h = health["replicas"][str(idx)]
            if not h["alive"] or h["retired"]:
                continue
            if h.get("model_version") != candidate_version:
                continue
            try:
                self.router.swap_one(idx, incumbent_vars,
                                     incumbent_version)
            except Exception:  # noqa: BLE001
                self.router.restart_replica(idx)

    # ---------------------------------------------------------- bookkeeping

    def _event(self, kind: str, version: str, **extra: Any) -> None:
        ev = {"event": kind, "version": version,
              "t_s": round(time.monotonic() - self._t0, 3)}
        ev.update(extra)
        with self._lock:
            self.history.append(ev)

    @staticmethod
    def _count(action: str) -> None:
        get_registry().counter_inc(
            "serve.publish_total",
            help="checkpoint publish outcomes by action",
            action=action)
