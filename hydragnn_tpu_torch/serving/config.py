"""Serving knobs: the `Serving` config block + HYDRAGNN_SERVE_* env layer
(counterpart: hydragnn_tpu/serving/config.py, `resolve_serving`).

Precedence per knob: env var over config block over default, with the
JAX package's defaults; env values are parsed strictly (a typo warns and
keeps the config's value).

    "Serving": {
        "enabled": false,          # engine path in run_prediction
        "max_batch_size": 32,      # requests coalesced per dispatch
        "max_wait_ms": 5.0,        # batching window for a lone request
        "num_buckets": 0,          # 0 = full capacity ladder
        "bucket_multiple": 64,     # shape rounding
        "max_queue": 0,            # bounded admission queue (0 = unbounded)
        "deadline_ms": 0.0,        # default per-request deadline (0 = none)
        "breaker_threshold": 5,    # consecutive batch failures to trip
        "breaker_reset_s": 30.0,   # open -> half-open probe window
        "precision": null,         # serve-side compute dtype override
        "quant_calib_samples": 32, # int8 calibration-set size
        "metrics_port": 0,         # /healthz + /metrics HTTP port (0 = off)
        "structure": false,        # raw-structure serving (submit_structure)
        "md_skin": 0.3,            # Verlet skin of trajectory sessions
        "md_farm": {               # InferenceEngine.trajectory_farm
            "steps_per_dispatch": 8,   # MD steps a replay (K)
            "cand_headroom": 0.5       # candidate/degree capacity headroom
        },
        "fleet": {                 # serving/fleet.py ReplicaRouter
            "replicas": 1,             # engines behind the router (<= 1:
                                       # the single engine)
            "compile_store": null,     # utils/devices.CompileStore dir
            "redispatch_max": 0,       # re-dispatches a request (0: one
                                       # try per replica)
            "drain_timeout_s": 30.0,   # a replica's drain bound (hot swap)
            "tier_priority_min": 0,    # > 0: a fleet.TierPolicy
            "tier_quota": 0.0,         # accurate tier's dispatch share cap
            "tier_fast": "int8",       # fast-tier engine tag
            "tier_accurate": "float32" # accurate-tier engine tag
        },
        "publish": {               # serving/publish.py CheckpointPublisher
            "poll_interval_s": 1.0, "mirror_every": 2, "window_pairs": 8,
            "min_pairs": 3, "window_timeout_s": 30.0, "max_rel_err": 0.25,
            "latency_factor": 3.0, "latency_floor_ms": 50.0
        },
        "autoscale": {             # serving/autoscale.py
            "min_replicas": 1, "max_replicas": 4, "high_depth": 4.0,
            "low_depth": 0.5, "cooldown_s": 5.0, "poll_interval_s": 1.0,
            "drain_timeout_s": 30.0, "signal": "queue_depth",
            "high_p99_ms": 500.0, "low_p99_ms": 50.0
        }
    }

The queue, deadline and breaker knobs are the engine's failure
semantics (serving/engine.py). `structure` (HYDRAGNN_SERVE_STRUCTURE)
makes run_prediction hand the engine the full config, so clients can
call `submit_structure` with raw positions; `md_skin` (HYDRAGNN_MD_SKIN,
cutoff units) is the skin their sessions' neighbour lists use.

`metrics_port` (HYDRAGNN_SERVE_METRICS_PORT) > 0 makes run_prediction
serve /healthz and /metrics (telemetry/http.py) on that loopback port
for the run. `md_farm` (`resolve_md_farm`, env
HYDRAGNN_MD_FARM_STEPS_PER_DISPATCH and HYDRAGNN_MD_FARM_CAND_HEADROOM)
holds the trajectory farm's knobs (md/farm.py).

`precision` (env HYDRAGNN_SERVE_PRECISION) takes the spellings of
train/precision.PRECISION_CHOICES: "float32" / "f32" / "fp32",
"bfloat16" / "bf16" or "int8" / "i8". Unset, the engine inherits the
train-side policy (HYDRAGNN_PRECISION, then Architecture.dtype). "int8"
makes every engine the int8 tier (quant/, serving/engine.py), calibrated
on `quant_calib_samples` samples (HYDRAGNN_QUANT_CALIB_SAMPLES, strict);
run_prediction's own loop computes at the train-side precision, as the
JAX package's does. The block also keeps any other numpy dtype name
(float16, ...) as JAX does; an engine built at one raises naming A5.

`fleet` (`resolve_fleet`; HYDRAGNN_FLEET_REPLICAS, _COMPILE_STORE,
_REDISPATCH_MAX, _DRAIN_TIMEOUT_S, _TIER_PRIORITY_MIN, _TIER_QUOTA,
_TIER_FAST, _TIER_ACCURATE): `replicas` > 1 makes run_prediction serve
through a ReplicaRouter of that many engines on the device;
`compile_store` points every replica at one store of kernel libraries.
`publish` (`resolve_publish`, HYDRAGNN_PUBLISH_*) sizes the
CheckpointPublisher's canary window and bounds; `autoscale`
(`resolve_autoscale`, HYDRAGNN_AUTOSCALE_*) the QueueDepthAutoscaler's
watermarks. Each resolves as the JAX package's does (strict parsing,
env over block over default), typos included.

One knob changes what JAX's run_prediction runs and is not ported yet,
so asking for it raises NotImplementedError naming ROADMAP A8:
run_prediction's `num_shards` > 1 (multi-device shards,
`check_unported_serving_knobs`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..train.precision import PRECISION_CHOICES, canonical_precision
from ..utils.envflags import (env_str, env_strict_choice, env_strict_flag,
                              env_strict_float, env_strict_int)


@dataclasses.dataclass(frozen=True)
class Structure:
    """One raw-structure request (the `submit_structure` schema):
    `positions` [N, 3]; `node_features` [N, sum(Dataset.node_features.dim)]
    in the dataset's layout (only the input columns are read; target
    columns may be zero-filled); `cell` [3, 3], required under
    periodic_boundary_conditions; `graph_feats`, accepted and ignored."""
    positions: Any
    node_features: Any
    cell: Optional[Any] = None
    graph_feats: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    enabled: bool = False
    max_batch_size: int = 32
    max_wait_ms: float = 5.0
    num_buckets: int = 0          # 0 = full ladder (1, 2, 4, ..., max)
    bucket_multiple: int = 64
    max_queue: int = 0            # 0 = unbounded admission queue
    deadline_ms: float = 0.0      # 0 = no default per-request deadline
    breaker_threshold: int = 5    # 0 disables the circuit breaker
    breaker_reset_s: float = 30.0
    precision: Optional[str] = None  # None = inherit the train-side policy
    quant_calib_samples: int = 32  # the int8 tier's calibration set
    metrics_port: int = 0         # /healthz + /metrics port (0 = off)
    structure: bool = False       # raw-structure serving (submit_structure)
    md_skin: float = 0.3          # Verlet skin of trajectory sessions


def check_unported_serving_knobs(num_shards: Optional[int] = None
                                 ) -> None:
    """Raise NotImplementedError naming A8 for `num_shards` > 1
    (run_prediction's multi-device shards), which the port does not
    serve yet."""
    if num_shards is not None and int(num_shards) > 1:
        raise NotImplementedError(
            f"num_shards={num_shards} (serving sharded over devices) is not "
            "ported to hydragnn_tpu_torch yet (ROADMAP A8: multi-device "
            "shards); run a fleet of replicas (Serving.fleet.replicas) "
            "instead")


@dataclasses.dataclass(frozen=True)
class MdFarm:
    """Trajectory-farm knobs (md/farm.py). They trade throughput for
    memory and host round trips; the grids, the selection rule and the
    bucket layout are not knobs."""
    steps_per_dispatch: int = 8   # MD steps a dispatch (one graph replay)
    cand_headroom: float = 0.5    # candidate and degree capacity headroom
    # over the initial per-trajectory builds


def resolve_md_farm(config: Optional[Dict[str, Any]] = None) -> MdFarm:
    """The `Serving.md_farm` block and the HYDRAGNN_MD_FARM_* env knobs,
    env over block over default (strict: a typo warns and keeps the
    block's value)."""
    block = ((config or {}).get("Serving", {}) or {}).get("md_farm",
                                                          {}) or {}
    base = MdFarm(
        steps_per_dispatch=int(block.get("steps_per_dispatch", 8)),
        cand_headroom=float(block.get("cand_headroom", 0.5)),
    )
    return MdFarm(
        steps_per_dispatch=env_strict_int(
            "HYDRAGNN_MD_FARM_STEPS_PER_DISPATCH",
            base.steps_per_dispatch),
        cand_headroom=env_strict_float("HYDRAGNN_MD_FARM_CAND_HEADROOM",
                                       base.cand_headroom),
    )


def resolve_serving(config: Optional[Dict[str, Any]]) -> ServingConfig:
    """The `Serving` block and the HYDRAGNN_SERVE_* env knobs merged into
    one ServingConfig."""
    block = (config or {}).get("Serving", {}) or {}
    base = ServingConfig(
        enabled=bool(block.get("enabled", False)),
        max_batch_size=int(block.get("max_batch_size", 32)),
        max_wait_ms=float(block.get("max_wait_ms", 5.0)),
        num_buckets=int(block.get("num_buckets", 0)),
        bucket_multiple=int(block.get("bucket_multiple", 64)),
        max_queue=int(block.get("max_queue", 0)),
        deadline_ms=float(block.get("deadline_ms", 0.0)),
        breaker_threshold=int(block.get("breaker_threshold", 5)),
        breaker_reset_s=float(block.get("breaker_reset_s", 30.0)),
        precision=canonical_precision(block.get("precision")),
        quant_calib_samples=int(block.get("quant_calib_samples", 32)
                                or 32),
        metrics_port=int(block.get("metrics_port", 0) or 0),
        structure=bool(block.get("structure", False)),
        md_skin=float(block.get("md_skin", 0.3)),
    )
    return ServingConfig(
        enabled=env_strict_flag("HYDRAGNN_SERVE", base.enabled),
        max_batch_size=env_strict_int("HYDRAGNN_SERVE_MAX_BATCH",
                                      base.max_batch_size),
        max_wait_ms=env_strict_float("HYDRAGNN_SERVE_MAX_WAIT_MS",
                                     base.max_wait_ms),
        num_buckets=env_strict_int("HYDRAGNN_SERVE_BUCKETS",
                                   base.num_buckets),
        bucket_multiple=env_strict_int("HYDRAGNN_SERVE_BUCKET_MULTIPLE",
                                       base.bucket_multiple),
        max_queue=env_strict_int("HYDRAGNN_SERVE_MAX_QUEUE",
                                 base.max_queue),
        deadline_ms=env_strict_float("HYDRAGNN_SERVE_DEADLINE_MS",
                                     base.deadline_ms),
        breaker_threshold=env_strict_int("HYDRAGNN_SERVE_BREAKER_THRESHOLD",
                                         base.breaker_threshold),
        breaker_reset_s=env_strict_float("HYDRAGNN_SERVE_BREAKER_RESET_S",
                                         base.breaker_reset_s),
        precision=env_strict_choice("HYDRAGNN_SERVE_PRECISION",
                                    PRECISION_CHOICES, base.precision),
        quant_calib_samples=env_strict_int("HYDRAGNN_QUANT_CALIB_SAMPLES",
                                           base.quant_calib_samples),
        metrics_port=env_strict_int("HYDRAGNN_SERVE_METRICS_PORT",
                                    base.metrics_port),
        structure=env_strict_flag("HYDRAGNN_SERVE_STRUCTURE",
                                  base.structure),
        md_skin=env_strict_float("HYDRAGNN_MD_SKIN", base.md_skin),
    )


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Replica-router knobs (serving/fleet.py). The routing contract
    (least queue depth, exactly-once resolution, per-replica breakers)
    is not a knob; these size the fleet and its recovery budgets."""
    replicas: int = 1             # <= 1 = the single-engine path
    compile_store: Optional[str] = None  # CompileStore dir
    redispatch_max: int = 0       # 0 = one try per replica
    drain_timeout_s: float = 30.0
    tier_priority_min: int = 0    # 0 = tier routing off; > 0 installs a
    # TierPolicy with this priority threshold (fleet.TierPolicy)
    tier_quota: float = 0.0       # max accurate-tier dispatch fraction
    # (0 = no cap)
    tier_fast: str = "int8"       # fast-tier engine tag
    tier_accurate: str = "float32"  # accurate-tier engine tag


def resolve_fleet(config: Optional[Dict[str, Any]] = None) -> FleetConfig:
    """The `Serving.fleet` block and the HYDRAGNN_FLEET_* env knobs, env
    over block over default (strict: a typo warns and keeps the block's
    value)."""
    block = ((config or {}).get("Serving", {}) or {}).get("fleet",
                                                          {}) or {}
    base = FleetConfig(
        replicas=int(block.get("replicas", 1) or 1),
        compile_store=(str(block.get("compile_store")).strip() or None
                       if block.get("compile_store") else None),
        redispatch_max=int(block.get("redispatch_max", 0) or 0),
        drain_timeout_s=float(block.get("drain_timeout_s", 30.0) or 30.0),
        tier_priority_min=int(block.get("tier_priority_min", 0) or 0),
        tier_quota=float(block.get("tier_quota", 0.0) or 0.0),
        tier_fast=str(block.get("tier_fast", "int8") or "int8"),
        tier_accurate=str(block.get("tier_accurate", "float32")
                          or "float32"),
    )
    return FleetConfig(
        replicas=env_strict_int("HYDRAGNN_FLEET_REPLICAS", base.replicas),
        compile_store=env_str("HYDRAGNN_FLEET_COMPILE_STORE",
                              base.compile_store),
        redispatch_max=env_strict_int("HYDRAGNN_FLEET_REDISPATCH_MAX",
                                      base.redispatch_max),
        drain_timeout_s=env_strict_float("HYDRAGNN_FLEET_DRAIN_TIMEOUT_S",
                                         base.drain_timeout_s),
        tier_priority_min=env_strict_int("HYDRAGNN_FLEET_TIER_PRIORITY_MIN",
                                         base.tier_priority_min),
        tier_quota=env_strict_float("HYDRAGNN_FLEET_TIER_QUOTA",
                                    base.tier_quota),
        tier_fast=env_str("HYDRAGNN_FLEET_TIER_FAST", base.tier_fast),
        tier_accurate=env_str("HYDRAGNN_FLEET_TIER_ACCURATE",
                              base.tier_accurate),
    )


@dataclasses.dataclass(frozen=True)
class PublishConfig:
    """CheckpointPublisher knobs (serving/publish.py). The canary
    contract (one replica, a shadow mirror, promote or quarantine, a
    coherent rollback) is not a knob; these size the window and its
    bounds."""
    poll_interval_s: float = 1.0   # BEST-marker poll cadence
    mirror_every: int = 2          # shadow slice: every k-th request
    window_pairs: int = 8          # pairs to adjudicate per canary
    min_pairs: int = 3             # fewer at timeout = aborted canary
    window_timeout_s: float = 30.0
    max_rel_err: float = 0.25      # candidate-vs-incumbent drift bound
    latency_factor: float = 3.0    # candidate p99 <= factor *
    # max(incumbent p99, latency_floor_ms)
    latency_floor_ms: float = 50.0


def resolve_publish(config: Optional[Dict[str, Any]] = None
                    ) -> PublishConfig:
    """The `Serving.publish` block and the HYDRAGNN_PUBLISH_* env knobs,
    env over block over default (strict)."""
    block = ((config or {}).get("Serving", {}) or {}).get("publish",
                                                          {}) or {}
    base = PublishConfig(
        poll_interval_s=float(block.get("poll_interval_s", 1.0) or 1.0),
        mirror_every=int(block.get("mirror_every", 2) or 2),
        window_pairs=int(block.get("window_pairs", 8) or 8),
        min_pairs=int(block.get("min_pairs", 3) or 3),
        window_timeout_s=float(block.get("window_timeout_s", 30.0)
                               or 30.0),
        max_rel_err=float(block.get("max_rel_err", 0.25) or 0.25),
        latency_factor=float(block.get("latency_factor", 3.0) or 3.0),
        latency_floor_ms=float(block.get("latency_floor_ms", 50.0)
                               or 50.0),
    )
    return PublishConfig(
        poll_interval_s=env_strict_float("HYDRAGNN_PUBLISH_POLL_S",
                                         base.poll_interval_s),
        mirror_every=env_strict_int("HYDRAGNN_PUBLISH_MIRROR_EVERY",
                                    base.mirror_every),
        window_pairs=env_strict_int("HYDRAGNN_PUBLISH_WINDOW_PAIRS",
                                    base.window_pairs),
        min_pairs=env_strict_int("HYDRAGNN_PUBLISH_MIN_PAIRS",
                                 base.min_pairs),
        window_timeout_s=env_strict_float(
            "HYDRAGNN_PUBLISH_WINDOW_TIMEOUT_S", base.window_timeout_s),
        max_rel_err=env_strict_float("HYDRAGNN_PUBLISH_MAX_REL_ERR",
                                     base.max_rel_err),
        latency_factor=env_strict_float("HYDRAGNN_PUBLISH_LATENCY_FACTOR",
                                        base.latency_factor),
        latency_floor_ms=env_strict_float(
            "HYDRAGNN_PUBLISH_LATENCY_FLOOR_MS", base.latency_floor_ms),
    )


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """QueueDepthAutoscaler knobs (serving/autoscale.py). Scale-down
    always drains and scale-up always joins on the published version;
    only the watermarks and bounds are knobs."""
    min_replicas: int = 1
    max_replicas: int = 4
    high_depth: float = 4.0   # mean routable queue depth -> scale up
    low_depth: float = 0.5    # mean routable queue depth -> scale down
    cooldown_s: float = 5.0   # min seconds between actions
    poll_interval_s: float = 1.0
    drain_timeout_s: float = 30.0
    signal: str = "queue_depth"  # "queue_depth" | "p99_latency": what the
    # watermarks compare against (p99_latency: the fleet-wide p99 of
    # `router.stats()`)
    high_p99_ms: float = 500.0   # p99 latency -> scale up
    low_p99_ms: float = 50.0     # p99 latency -> scale down


def resolve_autoscale(config: Optional[Dict[str, Any]] = None
                      ) -> AutoscaleConfig:
    """The `Serving.autoscale` block and the HYDRAGNN_AUTOSCALE_* env
    knobs, env over block over default (strict)."""
    block = ((config or {}).get("Serving", {}) or {}).get("autoscale",
                                                          {}) or {}
    base = AutoscaleConfig(
        min_replicas=int(block.get("min_replicas", 1) or 1),
        max_replicas=int(block.get("max_replicas", 4) or 4),
        high_depth=float(block.get("high_depth", 4.0) or 4.0),
        low_depth=float(block.get("low_depth", 0.5) or 0.5),
        cooldown_s=float(block.get("cooldown_s", 5.0) or 5.0),
        poll_interval_s=float(block.get("poll_interval_s", 1.0) or 1.0),
        drain_timeout_s=float(block.get("drain_timeout_s", 30.0) or 30.0),
        signal=str(block.get("signal", "queue_depth") or "queue_depth"),
        high_p99_ms=float(block.get("high_p99_ms", 500.0) or 500.0),
        low_p99_ms=float(block.get("low_p99_ms", 50.0) or 50.0),
    )
    return AutoscaleConfig(
        min_replicas=env_strict_int("HYDRAGNN_AUTOSCALE_MIN",
                                    base.min_replicas),
        max_replicas=env_strict_int("HYDRAGNN_AUTOSCALE_MAX",
                                    base.max_replicas),
        high_depth=env_strict_float("HYDRAGNN_AUTOSCALE_HIGH_DEPTH",
                                    base.high_depth),
        low_depth=env_strict_float("HYDRAGNN_AUTOSCALE_LOW_DEPTH",
                                   base.low_depth),
        cooldown_s=env_strict_float("HYDRAGNN_AUTOSCALE_COOLDOWN_S",
                                    base.cooldown_s),
        poll_interval_s=env_strict_float("HYDRAGNN_AUTOSCALE_POLL_S",
                                         base.poll_interval_s),
        drain_timeout_s=env_strict_float(
            "HYDRAGNN_AUTOSCALE_DRAIN_TIMEOUT_S", base.drain_timeout_s),
        signal=env_strict_choice(
            "HYDRAGNN_AUTOSCALE_SIGNAL",
            {"queue_depth": "queue_depth", "p99_latency": "p99_latency"},
            base.signal),
        high_p99_ms=env_strict_float("HYDRAGNN_AUTOSCALE_HIGH_P99_MS",
                                     base.high_p99_ms),
        low_p99_ms=env_strict_float("HYDRAGNN_AUTOSCALE_LOW_P99_MS",
                                    base.low_p99_ms),
    )
