"""The serving fleet: a replica router over N inference engines
(counterpart: hydragnn_tpu/serving/fleet.py, whose names, contract and
counters this module keeps).

* ``ReplicaRouter`` fronts N ``InferenceEngine`` replicas, each built by
  the caller's ``engine_factory(idx)`` with its own model copy, graphs
  and breaker: one replica's tripped breaker or dead dispatcher never
  refuses traffic the others can serve.
* Dispatch is least queue depth over the routable replicas (alive,
  breaker closed, not draining, not the canary), ties by index, replicas
  whose breaker is due a probe first: a pure function of the health
  snapshot (``_pick``, ``_pick_from``). Under a ``TierPolicy`` the
  candidates narrow to the request's preferred tier first
  (``_preferred_tier``: priority at or above ``priority_min`` prefers the
  accurate tier, within its dispatch ``quota``), with a counted
  cross-tier fallback.
* A request that fails for a replica's reasons (a dead dispatcher, a
  breaker's refusal, a failed batch) is re-dispatched to another
  replica, at most ``max_redispatch`` times; the router's future
  resolves exactly once, and a killed replica's late result is counted
  and dropped (execution at least once under a kill, resolution exactly
  once). A request's own failures (deadline, schema) resolve at once.
* ``kill_replica`` (the ``replica-kill`` fault site fires once per
  router dispatch and kills the replica it picked) takes a replica out
  of rotation and re-dispatches its in-flight requests;
  ``restart_replica`` builds a replacement from the factory, which warms
  from a shared compile store (utils/devices.CompileStore) without
  building a kernel.
* ``hot_swap`` upgrades the model one replica at a time: drain, the
  engine's ``swap_variables``, back into rotation; a ``swap-fail`` leaves
  that replica on the old version and no request fails.
  ``hot_swap_from_checkpoint`` feeds it from the BEST/LATEST committed
  checkpoint (utils/checkpoint.py). The version tag is echoed on every
  future and in ``health()``.
* For the publisher and the autoscaler: ``set_canary``, ``swap_one``,
  ``install_mirror``, ``quarantine_version``, ``record_published``,
  ``add_replica`` and ``retire_replica``.
* ``start_metrics_server`` serves one aggregated /healthz and /metrics
  with per-replica labels (telemetry/http.py ``fleet_prometheus``).

Replicas on one card. The JAX package's replicas were compiled programs;
here each replica is an engine with its own CUDA graphs, and restarts,
scale-ups and hot swaps happen while the other replicas serve. The rule
that makes that safe, and that the engine keeps:

* every replica does all its device work (the copy into the bucket's
  static batch, the replay, the copy of the outputs to the host, and its
  captures) on its own non-default stream, never on the legacy default
  stream, so no replica's work joins another replica's capture;
* every capture, and every release of a replica's graphs, holds the
  device's capture lock (train/step_graphs.capture_lock), and captures
  run in thread-local mode: captures happen one at a time, next to the
  other replicas' replays, and no pool is freed under a capture;
* a replica whose engine is shut down (``kill_replica``, ``retire_
  replica``, a restart) drops its graphs and their memory pool when its
  dispatcher exits, so restarts do not accumulate device memory.

A replica that fails to capture or to launch fails its batch, which the
router re-dispatches and counts; nothing falls back to an eager or a CPU
forward. Replicas sit on the caller's device, as the JAX package's
run_prediction ignores the replica index.

Lock discipline: engine calls (submit, health, swap) are made outside the
router lock; the lock order is router, then engine, and engines resolve
futures outside their own lock, so the two cannot deadlock.
"""
from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

from ..telemetry.registry import get_registry
from ..utils.faults import InjectedFault, fault_point
from ..utils.profiling import latency_percentiles
from .engine import (CircuitOpenError, DeadlineExceededError,
                     InferenceEngine, QueueFullError, ServingError)

_log = logging.getLogger("hydragnn_tpu_torch")


class FleetUnavailableError(ServingError):
    """No routable replica: every replica is dead, shut down, or
    breaker-open inside its window (and none is due a probe)."""


class SwapFailedError(ServingError):
    """hot_swap could not swap one or more replicas (the report names
    them); the failed replicas keep serving the old version."""


@dataclass(frozen=True)
class TierPolicy:
    """Priority and quota routing between two engine tiers. `fast` and
    `accurate` name the engines' ``tier`` tags (default: their compute
    dtype). A request with ``priority >= priority_min`` prefers the
    accurate tier, others the fast tier; ``quota`` in (0, 1] caps the
    share of all dispatches the accurate tier may take (0: no cap), and a
    priority request over it is downgraded (counted). When the preferred
    tier has no routable replica the request falls back to the other
    (counted)."""

    fast: str = "int8"
    accurate: str = "float32"
    priority_min: int = 1
    quota: float = 0.0

    def __post_init__(self):
        if not (0.0 <= float(self.quota) <= 1.0):
            raise ValueError(
                f"TierPolicy.quota={self.quota!r} must be in [0, 1] — "
                "it is the max fraction of dispatches the accurate "
                "tier may absorb (0 disables the cap)")
        if str(self.fast) == str(self.accurate):
            raise ValueError(
                f"TierPolicy fast and accurate tiers are both "
                f"{self.fast!r} — a one-tier fleet needs no policy")


class _RouterRequest:
    """One router-level request: the caller's future and its re-dispatch
    bookkeeping. `resolved` flips once, under the router lock."""

    __slots__ = ("sample", "future", "deadline_ms", "priority",
                 "attempts", "tried", "resolved", "wait_deadline")

    def __init__(self, sample, deadline_ms, priority=0):
        self.sample = sample
        self.future: Future = Future()
        self.deadline_ms = deadline_ms
        self.priority = int(priority)
        self.attempts = 0   # dispatches consumed (first + re-dispatches)
        self.tried = set()  # replica indices that failed this request
        self.resolved = False
        # one wait budget for a transiently unroutable fleet, over the
        # request's lifetime (set at its first _await_routable)
        self.wait_deadline = None


class _Replica:
    """The router's view of one replica; its fields are guarded by the
    router lock."""

    __slots__ = ("idx", "engine", "alive", "draining", "inflight",
                 "dispatched", "canary", "retired")

    def __init__(self, idx: int, engine: InferenceEngine):
        self.idx = idx
        self.engine = engine
        self.alive = True
        self.draining = False
        self.inflight: Dict[_RouterRequest, Future] = {}
        self.dispatched = 0
        self.canary = False   # out of rotation; serves the shadow slice
        self.retired = False  # scaled down; restart_replica revives it


class ReplicaRouter:
    """N-replica serving fleet: least-queue-depth dispatch, per-replica
    failure isolation, exactly-once resolution under replica death,
    hot swap, restarts warmed from the compile store.

    `engine_factory(idx)` builds replica `idx`'s InferenceEngine (its own
    model copy on the device, the shared compile store); the replicas
    must take the same request schema. All replicas are built at
    construction."""

    def __init__(self, engine_factory: Callable[[int], InferenceEngine],
                 num_replicas: int, *,
                 max_redispatch: Optional[int] = None,
                 drain_timeout_s: float = 30.0,
                 unavailable_wait_s: float = 5.0,
                 tier_policy: Optional[TierPolicy] = None):
        if num_replicas < 1:
            raise ValueError("ReplicaRouter needs num_replicas >= 1")
        self._factory = engine_factory
        self.tier_policy = tier_policy
        self._replicas: List[_Replica] = [
            _Replica(i, engine_factory(i)) for i in range(num_replicas)]
        # one try per replica by default
        self.max_redispatch = (int(max_redispatch)
                               if max_redispatch is not None
                               else max(num_replicas - 1, 0))
        self.drain_timeout_s = float(drain_timeout_s)
        # how long a request waits for a drain or a probe to end when it
        # left no routable replica
        self.unavailable_wait_s = float(unavailable_wait_s)
        self._lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
        self.requests_done = 0  # guarded-by: _lock
        self.redispatch_count = 0  # guarded-by: _lock
        # late results from killed or raced replicas, dropped
        self.duplicate_resolutions = 0  # guarded-by: _lock
        # failures of a dispatch kill_replica already superseded, dropped
        self.stale_failures = 0  # guarded-by: _lock
        self.kill_count = 0  # guarded-by: _lock
        self.restart_count = 0  # guarded-by: _lock
        self.swap_attempts = 0  # guarded-by: _lock
        self.swap_failures = 0  # guarded-by: _lock
        self.tier_fallbacks = 0  # guarded-by: _lock
        self.tier_downgrades = 0  # guarded-by: _lock
        self._tier_dispatches: Dict[str, int] = {}  # guarded-by: _lock
        self.shadow_mirrored = 0  # guarded-by: _lock
        self.shadow_dropped = 0  # guarded-by: _lock
        self.retire_count = 0  # guarded-by: _lock
        self.add_count = 0  # guarded-by: _lock
        # version -> reason; hot_swap and swap_one refuse these
        self._quarantined: Dict[str, str] = {}  # guarded-by: _lock
        # {"replica", "every", "on_pair"} while a canary window is open
        self._mirror = None  # guarded-by: _lock
        self._mirror_seq = 0  # guarded-by: _lock
        # (variables, version) of the last fleet-wide publish; replicas
        # added or restarted later swap to it before joining rotation
        self._published = None  # guarded-by: _lock
        self._metrics_server = None

    # ------------------------------------------------------------ client API

    def submit(self, sample, deadline_ms: Optional[float] = None,
               priority: int = 0) -> Future:
        """Route one request; the returned Future resolves exactly once,
        with the result of the replica that served it (re-dispatched
        across replica death, breaker refusals and failed batches) or
        with the terminal error. It carries the serving engine's
        breadcrumbs (`.bucket`, `.parity*`, `.model_version`, `.tier`)
        and `.replica`. `priority` matters only under a `tier_policy`."""
        rr = _RouterRequest(sample, deadline_ms, priority=priority)
        mirror = None
        with self._lock:
            if self._mirror is not None:
                self._mirror_seq += 1
                if self._mirror_seq % self._mirror["every"] == 0:
                    mirror = dict(self._mirror)
        self._dispatch(rr)
        if mirror is not None:
            self._mirror_submit(mirror, rr)
        return rr.future

    def predict(self, samples: Sequence, timeout=None):
        """Submit all samples, wait, return the results in order."""
        futs = [self.submit(s) for s in samples]
        return [f.result(timeout=timeout) for f in futs]

    @staticmethod
    def _warm(rep_idx: int, engine: InferenceEngine) -> dict:
        t0 = time.perf_counter()
        engine.warmup()
        st = engine.stats()
        return {"replica": rep_idx, "compiled": st["compile_count"],
                "store_hits": st["compile_store_hits"],
                "fresh": st["compile_fresh"], "captures": st["captures"],
                "capture_ms": float(sum(engine.capture_ms.values())),
                "warmup_s": time.perf_counter() - t0}

    def warmup(self) -> List[dict]:
        """Warm every live replica's bucket ladder; a report per replica:
        {replica, compiled, store_hits, fresh} as the JAX router gives
        it, and the port's `captures`, `capture_ms` (its graphs, captured
        in every process) and `warmup_s`. On a populated store `fresh`
        is 0."""
        reports = []
        for rep in self._replicas:
            with self._lock:
                skip = not rep.alive
            if not skip:
                reports.append(self._warm(rep.idx, rep.engine))
        return reports

    def health(self) -> dict:
        """"serving" while at least one replica is routable, else
        "unavailable"; "shutdown" after shutdown(). Every replica's own
        health() by index, with the router's flags, and the counters."""
        with self._lock:
            closed = self._closed
            reps = list(self._replicas)
            alive = {r.idx: r.alive for r in reps}
            draining = {r.idx: r.draining for r in reps}
            dispatched = {r.idx: r.dispatched for r in reps}
            canary = {r.idx: r.canary for r in reps}
            retired = {r.idx: r.retired for r in reps}
            counters = {
                "requests_done": self.requests_done,
                "redispatches": self.redispatch_count,
                "duplicate_resolutions": self.duplicate_resolutions,
                "stale_failures": self.stale_failures,
                "kills": self.kill_count,
                "restarts": self.restart_count,
                "swap_attempts": self.swap_attempts,
                "swap_failures": self.swap_failures,
                "tier_fallbacks": self.tier_fallbacks,
                "tier_downgrades": self.tier_downgrades,
                "tier_dispatches": {
                    t: self._tier_dispatches[t]
                    for t in sorted(self._tier_dispatches)},
                "shadow_mirrored": self.shadow_mirrored,
                "shadow_dropped": self.shadow_dropped,
                "retires": self.retire_count,
                "adds": self.add_count,
                "quarantined_versions": sorted(self._quarantined),
            }
        replicas = {}
        routable = 0
        for rep in reps:
            h = rep.engine.health()
            h["alive"] = alive[rep.idx]
            h["draining"] = draining[rep.idx]
            h["dispatched"] = dispatched[rep.idx]
            h["canary"] = canary[rep.idx]
            h["retired"] = retired[rep.idx]
            # as _pick decides: a half-open replica's probe owns its
            # breaker, and a canary serves only the shadow slice
            if (alive[rep.idx] and not draining[rep.idx]
                    and not canary[rep.idx]
                    and h["dispatcher_alive"]
                    and (h["state"] == "closed"
                         or h.get("breaker_probe_due"))):
                routable += 1
            replicas[str(rep.idx)] = h
        state = ("shutdown" if closed
                 else "serving" if routable else "unavailable")
        out = {"state": state, "num_replicas": len(reps),
               "routable_replicas": routable, "replicas": replicas}
        out.update(counters)
        return out

    def stats(self) -> dict:
        """The counters, each replica's stats() by index, the request
        and batch sums, and fleet-wide latency percentiles over the
        replicas' raw latencies pooled."""
        with self._lock:
            reps = list(self._replicas)
            out = {
                "requests_done": self.requests_done,
                "redispatches": self.redispatch_count,
                "duplicate_resolutions": self.duplicate_resolutions,
                "stale_failures": self.stale_failures,
                "kills": self.kill_count,
                "restarts": self.restart_count,
                "tier_fallbacks": self.tier_fallbacks,
                "tier_downgrades": self.tier_downgrades,
                "tier_dispatches": {
                    t: self._tier_dispatches[t]
                    for t in sorted(self._tier_dispatches)},
                "shadow_mirrored": self.shadow_mirrored,
                "shadow_dropped": self.shadow_dropped,
                "retires": self.retire_count,
                "adds": self.add_count,
                "quarantined_versions": sorted(self._quarantined),
                "canary_replicas": sorted(r.idx for r in self._replicas
                                          if r.canary),
            }
        latencies: List[float] = []
        per_replica = {}
        for rep in reps:
            per_replica[str(rep.idx)] = rep.engine.stats()
            latencies.extend(rep.engine.latency_snapshot())
        out["replicas"] = per_replica
        out["requests"] = sum(st["requests"]
                              for st in per_replica.values())
        out["batches"] = sum(st["batches"] for st in per_replica.values())
        out.update(latency_percentiles(latencies))
        return out

    def reset_stats(self) -> None:
        """Zero every replica's service counters (the router's counters
        and the graphs stay)."""
        with self._lock:
            reps = list(self._replicas)
        for rep in reps:
            rep.engine.reset_stats()

    def start_metrics_server(self, host: str = "127.0.0.1", port: int = 0):
        """One HTTP endpoint for the fleet (telemetry/http.py): GET
        /healthz gives health() (200 while a replica is routable), GET
        /metrics the per-replica-labelled Prometheus text and the process
        registry. `port=0` binds an ephemeral port (`server.port`);
        shutdown() stops it."""
        if self._metrics_server is not None:
            return self._metrics_server
        from ..telemetry.http import serve_fleet_metrics
        self._metrics_server = serve_fleet_metrics(self, host=host,
                                                   port=port)
        return self._metrics_server

    def shutdown(self, wait: bool = True):
        """Stop routing and shut every replica down (each drains its own
        queue). Idempotent."""
        server, self._metrics_server = self._metrics_server, None
        if server is not None:
            server.stop()
        with self._lock:
            self._closed = True
            reps = list(self._replicas)
        for rep in reps:
            rep.engine.shutdown(wait=wait)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.shutdown(wait=True)
        return False

    # -------------------------------------------------- failure / lifecycle

    def kill_replica(self, idx: int) -> int:
        """A replica's death (the ``replica-kill`` fault's effect): it
        leaves rotation at once and its in-flight requests re-dispatch;
        returns how many. Its engine shuts down without waiting; what it
        still resolves is dropped by the exactly-once gate, and its
        graphs go when its dispatcher exits."""
        with self._lock:
            rep = self._replicas[idx]
            if not rep.alive:
                return 0
            rep.alive = False
            self.kill_count += 1
            victims = list(rep.inflight)
            rep.inflight.clear()
        get_registry().counter_inc(
            "serve.fleet_kills_total",
            help="replicas removed from rotation by kill_replica")
        rep.engine.shutdown(wait=False)
        moved = 0
        for rr in victims:
            with self._lock:
                if rr.resolved:
                    continue
                rr.tried.add(idx)
                self.redispatch_count += 1
            moved += 1
            get_registry().counter_inc(
                "serve.fleet_redispatches_total",
                help="requests re-dispatched off a dead/failed replica")
            self._dispatch(rr)
        return moved

    def restart_replica(self, idx: int, warmup: bool = True) -> dict:
        """Replace replica `idx` (dead, retired or live) with a fresh
        engine from the factory, swapped to the fleet's published
        version, and return its warm-up report; with a shared compile
        store `fresh` is 0. A live replica's in-flight requests
        re-dispatch, as under a kill."""
        engine = self._factory(idx)
        self._reconcile_engine(engine)
        with self._lock:
            rep = self._replicas[idx]
            old_engine, was_alive = rep.engine, rep.alive
            victims = list(rep.inflight)
            rep.engine = engine
            rep.alive = True
            rep.draining = False
            rep.retired = False
            rep.canary = False
            rep.inflight = {}
            self.restart_count += 1
        if was_alive:
            old_engine.shutdown(wait=False)
        for rr in victims:
            with self._lock:
                if rr.resolved:
                    continue
                self.redispatch_count += 1
            self._dispatch(rr)
        if not warmup:
            return {"replica": idx, "compiled": 0, "store_hits": 0,
                    "fresh": 0, "captures": 0, "capture_ms": 0.0,
                    "warmup_s": 0.0}
        return self._warm(idx, engine)

    def drain_replica(self, idx: int,
                      timeout_s: Optional[float] = None) -> None:
        """Take replica `idx` out of rotation and wait until its in-flight
        requests and its queue are empty (`undrain_replica` re-admits
        it). Raises TimeoutError past `timeout_s`, re-admitting it."""
        deadline = time.monotonic() + (self.drain_timeout_s
                                       if timeout_s is None
                                       else float(timeout_s))
        with self._lock:
            rep = self._replicas[idx]
            rep.draining = True
        while True:
            with self._lock:
                inflight = len(rep.inflight)
            depth = rep.engine.health()["queue_depth"]
            if inflight == 0 and depth == 0:
                return
            if time.monotonic() >= deadline:
                with self._lock:
                    rep.draining = False
                raise TimeoutError(
                    f"replica {idx} did not drain in time "
                    f"({inflight} in flight, queue depth {depth})")
            time.sleep(0.002)

    def undrain_replica(self, idx: int) -> None:
        with self._lock:
            self._replicas[idx].draining = False

    # --------------------------------------------- canary / publish plumbing

    def set_canary(self, idx: int, on: bool = True) -> None:
        """Flag replica `idx` as the canary: out of the primary rotation,
        alive for the mirrored shadow slice."""
        with self._lock:
            self._replicas[idx].canary = bool(on)

    def swap_one(self, idx: int, variables, version: str) -> dict:
        """Drain replica `idx`, swap its weights, re-admit it. Raises
        ValueError for a dead or retired replica or a quarantined
        version; a failed swap (`swap-fail`, a mismatched tree) raises
        after the replica is re-admitted on its old version."""
        with self._lock:
            if str(version) in self._quarantined:
                reason = self._quarantined[str(version)]
                raise ValueError(
                    f"version {version!r} is quarantined ({reason}) — "
                    "clear it via quarantine_version bookkeeping before "
                    "re-publishing")
            rep = self._replicas[idx]
            if not rep.alive or rep.retired:
                raise ValueError(
                    f"replica {idx} is "
                    f"{'retired' if rep.retired else 'dead'} — cannot "
                    "swap; restart_replica revives it first")
            self.swap_attempts += 1
        self.drain_replica(idx)
        try:
            old = rep.engine.swap_variables(variables, version)
        except (InjectedFault, ValueError, TimeoutError, RuntimeError):
            with self._lock:
                self.swap_failures += 1
            raise
        finally:
            self.undrain_replica(idx)
        return {"replica": idx, "from": old, "to": str(version)}

    def install_mirror(self, idx: int, every: int,
                       on_pair: Callable[[Future, Future], None]) -> None:
        """Mirror every `every`-th submit() also onto replica `idx`'s
        engine (a shadow copy that never touches the primary future) and
        call `on_pair(primary_future, shadow_future)`."""
        if every < 1:
            raise ValueError(f"mirror every={every!r} must be >= 1")
        with self._lock:
            self._mirror = {"replica": int(idx), "every": int(every),
                            "on_pair": on_pair}
            self._mirror_seq = 0

    def remove_mirror(self) -> None:
        with self._lock:
            self._mirror = None

    def _mirror_submit(self, mirror: dict, rr: _RouterRequest) -> None:
        """The shadow copy on the canary's engine, outside the router
        lock; a canary that cannot take it drops it (counted)."""
        with self._lock:
            rep = self._replicas[mirror["replica"]]
            ok = rep.alive and rep.canary and not rep.draining
        if ok:
            try:
                shadow = rep.engine.submit(rr.sample,
                                           deadline_ms=rr.deadline_ms)
            except (ServingError, RuntimeError):
                ok = False
        if not ok:
            with self._lock:
                self.shadow_dropped += 1
            return
        with self._lock:
            self.shadow_mirrored += 1
        try:
            mirror["on_pair"](rr.future, shadow)
        except Exception:  # noqa: BLE001 — never breaks the serving path
            _log.warning("shadow-mirror on_pair callback raised",
                         exc_info=True)

    def quarantine_version(self, version: str, reason: str = "") -> None:
        """Ban a model version: hot_swap and swap_one refuse it and the
        publisher skips it."""
        with self._lock:
            self._quarantined[str(version)] = str(reason)
        get_registry().counter_inc(
            "serve.fleet_quarantines_total",
            help="model versions quarantined after a failed canary")

    def quarantined_versions(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._quarantined)

    def record_published(self, variables, version: str) -> None:
        """Record the fleet-wide weights: replicas added or restarted
        later swap to this version before joining rotation. hot_swap
        records it after a roll with no failure, the publisher after a
        promote."""
        with self._lock:
            self._published = (variables, str(version))

    def _reconcile_engine(self, engine) -> None:
        with self._lock:
            published = self._published
        if published is None:
            return
        variables, version = published
        if getattr(engine, "model_version", None) != version:
            engine.swap_variables(variables, version)

    # ----------------------------------------------------------- autoscaling

    def add_replica(self, warmup: bool = True) -> dict:
        """Grow the fleet by one replica from the factory (the
        autoscaler's scale-up), on the published version, warmed from the
        store; returns its warm-up report. One writer only: a raced add
        raises."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ReplicaRouter is shut down")
            idx = len(self._replicas)
        engine = self._factory(idx)
        self._reconcile_engine(engine)
        with self._lock:
            if len(self._replicas) != idx:
                raise RuntimeError(
                    "concurrent add_replica detected — the autoscaler "
                    "is the single scale writer")
            self._replicas.append(_Replica(idx, engine))
            self.add_count += 1
        get_registry().counter_inc(
            "serve.fleet_adds_total",
            help="replicas added to the fleet by add_replica")
        if not warmup:
            return {"replica": idx, "compiled": 0, "store_hits": 0,
                    "fresh": 0, "captures": 0, "capture_ms": 0.0,
                    "warmup_s": 0.0}
        return self._warm(idx, engine)

    def retire_replica(self, idx: int,
                       timeout_s: Optional[float] = None) -> dict:
        """Scale replica `idx` down through a drain (no future lost),
        then shut its engine down; the slot stays, flagged `retired`, for
        restart_replica. Raises ValueError for a dead, retired or canary
        replica and TimeoutError past the drain bound (re-admitted)."""
        with self._lock:
            rep = self._replicas[idx]
            if not rep.alive or rep.retired:
                raise ValueError(f"replica {idx} is already "
                                 f"{'retired' if rep.retired else 'dead'}")
            if rep.canary:
                raise ValueError(
                    f"replica {idx} is the canary — a publish "
                    "adjudication owns it; retire another replica")
        self.drain_replica(idx, timeout_s)
        # `draining` is still set: no dispatch lands before the flags
        with self._lock:
            rep.alive = False
            rep.retired = True
            rep.draining = False
            self.retire_count += 1
        rep.engine.shutdown(wait=False)
        get_registry().counter_inc(
            "serve.fleet_retires_total",
            help="replicas scaled down through drain by retire_replica")
        return {"replica": idx, "retired": True}

    def hot_swap(self, variables, version: str,
                 raise_on_failure: bool = True) -> dict:
        """Rolling upgrade: for each live replica, drain (the rest serve),
        `swap_variables`, back into rotation. A replica whose swap fails
        keeps the old version and is reported in `failed`; with
        `raise_on_failure` a SwapFailedError naming both sides of the
        mixed fleet follows the whole roll."""
        with self._lock:
            if str(version) in self._quarantined:
                reason = self._quarantined[str(version)]
                raise ValueError(
                    f"version {version!r} is quarantined ({reason}) — "
                    "refusing to roll it out")
            self.swap_attempts += 1
            reps = [r for r in self._replicas if r.alive]
        report = {"version": str(version), "replicas": {}, "failed": []}
        for rep in reps:
            try:
                self.drain_replica(rep.idx)
                try:
                    old = rep.engine.swap_variables(variables, version)
                    report["replicas"][str(rep.idx)] = {
                        "from": old, "to": str(version)}
                finally:
                    self.undrain_replica(rep.idx)
            except (InjectedFault, ValueError, TimeoutError,
                    RuntimeError) as exc:
                with self._lock:
                    self.swap_failures += 1
                report["failed"].append(
                    {"replica": rep.idx, "error":
                     f"{type(exc).__name__}: {exc}"})
                _log.warning("hot-swap to %s failed on replica %d (%s); "
                             "the old version keeps serving there",
                             version, rep.idx, exc)
        get_registry().counter_inc(
            "serve.fleet_swaps_total",
            help="hot-swap rolls attempted across the fleet")
        if not report["failed"]:
            self.record_published(variables, version)
        elif raise_on_failure:
            on_new = sorted(int(i) for i in report["replicas"])
            on_old = sorted(f["replica"] for f in report["failed"])
            exc = SwapFailedError(
                f"hot-swap to {version!r} failed on "
                f"{len(report['failed'])} replica(s): {report['failed']} "
                f"— MIXED-VERSION fleet: replicas {on_new} serve "
                f"{version!r}, replicas {on_old} keep the old version; "
                "fix the checkpoint and re-run hot_swap, or roll the "
                f"{on_new or 'swapped'} replicas back via swap_one")
            exc.report = report
            raise exc
        return report

    def hot_swap_from_checkpoint(self, state_template, log_name: str,
                                 path: str = "./logs",
                                 which: str = "best",
                                 version: Optional[str] = None) -> dict:
        """hot_swap from the BEST (or LATEST) committed checkpoint of run
        `log_name`, restored on `state_template` (a TrainState of the
        served architecture); the version defaults to
        "<which>:step_<n>". A marker that names an uncommitted dir raises
        UncommittedCheckpointError naming it."""
        from ..utils.checkpoint import (UncommittedCheckpointError,
                                        load_best_model,
                                        load_existing_model,
                                        marker_target, verify_checkpoint)
        from ..utils.weights import export_jax_variables
        if which not in ("best", "latest"):
            raise ValueError(
                f"which={which!r} — hot_swap_from_checkpoint restores "
                "'best' (the BEST marker) or 'latest' (the LATEST marker)")
        target = marker_target(log_name, path=path, which=which)
        if target is not None and not verify_checkpoint(target):
            raise UncommittedCheckpointError(
                f"the {which.upper()} marker for run '{log_name}' names "
                f"{target}, which has no COMMITTED marker (a writer died "
                "mid-save or is still writing) — refusing to hot-swap a "
                "torn state. Wait for the in-flight save "
                "(utils.checkpoint.wait_for_checkpoints) or repoint/"
                "delete the marker, then retry")
        if which == "best":
            state = load_best_model(state_template, log_name, path=path)
        else:
            state = load_existing_model(state_template, log_name, path=path)
        if state is None:
            raise FileNotFoundError(
                f"no verified {which.upper()} checkpoint for run "
                f"'{log_name}' under {path}")
        if version is None:
            version = f"{which}:step_{int(state.step)}"
        return self.hot_swap(export_jax_variables(state), version)

    # ------------------------------------------------------------- dispatch

    def _pick(self, rr: _RouterRequest) -> Optional[_Replica]:
        """The routing policy over the health snapshot: probe-due
        replicas first, then the closed one with the least queue depth,
        ties by index; replicas this request failed on only when nothing
        else is left; under a tier policy the preferred tier first, then
        the rest (a counted fallback)."""
        with self._lock:
            candidates = [r for r in self._replicas
                          if r.alive and not r.draining and not r.canary]
        untried = [r for r in candidates if r.idx not in rr.tried]
        if untried:
            candidates = untried
        preferred = self._preferred_tier(rr)
        if preferred is None:
            return self._pick_from(candidates)
        pref = [r for r in candidates
                if getattr(r.engine, "tier", None) == preferred]
        chosen = self._pick_from(pref) if pref else None
        if chosen is not None:
            return chosen
        rest = [r for r in candidates if r not in pref]
        chosen = self._pick_from(rest)
        if chosen is not None:
            with self._lock:
                self.tier_fallbacks += 1
            get_registry().counter_inc(
                "serve.fleet_tier_fallbacks_total",
                help="requests served by the non-preferred tier because "
                     "the preferred tier had no routable replica")
        return chosen

    def _pick_from(self, candidates: List[_Replica]
                   ) -> Optional[_Replica]:
        """Probe-due first, then the least queue depth among closed
        breakers, ties by index; a dead replica met on the way is marked
        dead."""
        closed = []
        probe_due = []
        for rep in candidates:
            h = rep.engine.health()
            if h["state"] == "shutdown" or not h["dispatcher_alive"]:
                self._mark_dead(rep)
                continue
            if h["state"] == "closed":
                closed.append((h["queue_depth"], rep.idx, rep))
            elif h["state"] == "open" and h["breaker_probe_due"]:
                probe_due.append(rep)
        if probe_due:
            return probe_due[0]
        if closed:
            return min(closed, key=lambda c: c[:2])[2]
        return None

    def _preferred_tier(self, rr: _RouterRequest) -> Optional[str]:
        """The tier this request should land on (None without a policy);
        a priority request over the accurate tier's quota is downgraded
        to the fast tier (counted once per pick)."""
        pol = self.tier_policy
        if pol is None:
            return None
        if rr.priority < pol.priority_min:
            return pol.fast
        if pol.quota > 0.0:
            with self._lock:
                acc = self._tier_dispatches.get(pol.accurate, 0)
                total = sum(self._tier_dispatches.values())
            if total > 0 and (acc + 1) / (total + 1) > pol.quota:
                with self._lock:
                    self.tier_downgrades += 1
                get_registry().counter_inc(
                    "serve.fleet_tier_downgrades_total",
                    help="priority requests routed to the fast tier "
                         "because the accurate tier was over quota")
                return pol.fast
        return pol.accurate

    def _mark_dead(self, rep: _Replica) -> None:
        with self._lock:
            rep.alive = False

    def _dispatch(self, rr: _RouterRequest) -> None:
        """Place `rr` on a replica, or resolve it with the terminal
        error. Runs on the submitting thread, or on a replica's
        dispatcher thread for a re-dispatch; never holds the router lock
        across an engine call."""
        last_err: Optional[BaseException] = None
        while True:
            with self._lock:
                closed = self._closed
            if closed:
                self._resolve(rr, exc=RuntimeError(
                    "ReplicaRouter is shut down"))
                return
            try:
                # replica-kill@k kills the replica the k-th router
                # dispatch picks
                fault_point("replica-kill")
                kill = False
            except InjectedFault:
                kill = True
            rep = self._pick(rr)
            if rep is None:
                if self._await_routable(rr):
                    continue
                self._resolve(rr, exc=FleetUnavailableError(
                    "no routable replica (all dead, draining, or "
                    "breaker-open)" + (f"; last error: {last_err}"
                                       if last_err else "")))
                return
            if kill:
                # the picked replica dies before this request lands; this
                # request was never registered there and just re-picks
                self.kill_replica(rep.idx)
                continue
            tier = getattr(rep.engine, "tier", None)
            with self._lock:
                if not rep.alive:  # killed between _pick and here
                    continue
                # registered before submit: a kill landing mid-submit
                # re-dispatches it
                rep.inflight[rr] = None
                rep.dispatched += 1
                rr.attempts += 1
                if tier is not None:
                    self._tier_dispatches[tier] = (
                        self._tier_dispatches.get(tier, 0) + 1)
                engine = rep.engine
            try:
                fut = engine.submit(rr.sample, deadline_ms=rr.deadline_ms)
            except (QueueFullError, CircuitOpenError) as exc:
                with self._lock:
                    rep.inflight.pop(rr, None)
                    rr.tried.add(rep.idx)
                last_err = exc
                if self._budget_spent(rr):
                    self._resolve(rr, exc=exc)
                    return
                continue
            except RuntimeError as exc:
                # the dispatcher died or the engine shut down: the replica
                # is gone, not the request
                with self._lock:
                    rep.inflight.pop(rr, None)
                    rr.tried.add(rep.idx)
                self._mark_dead(rep)
                last_err = exc
                if self._budget_spent(rr):
                    self._resolve(rr, exc=exc)
                    return
                continue
            with self._lock:
                if rr in rep.inflight:
                    rep.inflight[rr] = fut
            fut.add_done_callback(
                lambda f, rr=rr, rep=rep: self._on_result(rr, rep, f))
            return

    def _budget_spent(self, rr: _RouterRequest) -> bool:
        with self._lock:
            return rr.attempts > self.max_redispatch

    def _await_routable(self, rr: _RouterRequest) -> bool:
        """While nothing is routable only for a moment (a drain or swap,
        a half-open probe in flight), wait within the request's one wait
        budget; True to pick again, False when the fleet is down."""
        if rr.wait_deadline is None:
            rr.wait_deadline = time.monotonic() + self.unavailable_wait_s
        while time.monotonic() < rr.wait_deadline:
            with self._lock:
                alive = [r for r in self._replicas
                         if r.alive and not r.canary]
                transient = any(r.draining for r in alive)
            if not transient:
                transient = any(
                    r.engine.health()["state"] == "half_open"
                    for r in alive)
            if not transient:
                return False
            time.sleep(0.002)
            with self._lock:
                ready = [r for r in self._replicas
                         if r.alive and not r.draining and not r.canary]
            if ready:
                return True
        return False

    def _on_result(self, rr: _RouterRequest, rep: _Replica,
                   fut: Future) -> None:
        """A replica's future resolved: settle the router's future once,
        or re-dispatch a replica-level failure. Runs on the replica's
        dispatcher thread."""
        with self._lock:
            registered = rr in rep.inflight
            rep.inflight.pop(rr, None)
            if rr.resolved:
                self.duplicate_resolutions += 1
                return
        exc = fut.exception()
        if exc is None:
            self._resolve(rr, result=fut.result(), source=fut,
                          replica=rep.idx)
            return
        if not registered:
            # kill_replica already moved this request: its live copy owns
            # the outcome
            with self._lock:
                self.stale_failures += 1
            return
        if isinstance(exc, (DeadlineExceededError, ValueError)):
            self._resolve(rr, exc=exc)
            return
        with self._lock:
            rr.tried.add(rep.idx)
        if self._budget_spent(rr):
            self._resolve(rr, exc=exc)
            return
        with self._lock:
            self.redispatch_count += 1
        get_registry().counter_inc(
            "serve.fleet_redispatches_total",
            help="requests re-dispatched off a dead/failed replica")
        self._dispatch(rr)

    def _resolve(self, rr: _RouterRequest, result=None, exc=None,
                 source: Optional[Future] = None,
                 replica: Optional[int] = None) -> bool:
        """The exactly-once gate: the first resolution wins, later ones
        are counted and dropped."""
        with self._lock:
            if rr.resolved:
                self.duplicate_resolutions += 1
                return False
            rr.resolved = True
            self.requests_done += 1
        if exc is not None:
            rr.future.set_exception(exc)
            return True
        if source is not None:
            for attr in ("bucket", "parity", "parity_rtol", "parity_atol",
                         "model_version", "tier", "rebuilt",
                         "graph_build_ms"):
                if hasattr(source, attr):
                    setattr(rr.future, attr, getattr(source, attr))
        if replica is not None:
            rr.future.replica = replica
        rr.future.set_result(result)
        return True
