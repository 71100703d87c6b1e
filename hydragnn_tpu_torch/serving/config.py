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
train/precision.PRECISION_CHOICES: "float32" / "f32" / "fp32" or
"bfloat16" / "bf16". Unset, the engine inherits the train-side policy
(HYDRAGNN_PRECISION, then Architecture.dtype).

Two knobs change what JAX's run_prediction starts and are not ported
yet, so asking for them raises NotImplementedError naming ROADMAP A8:
`fleet.replicas` > 1 (HYDRAGNN_FLEET_REPLICAS: a replica router) and
precision "int8" (the int8 serving tier).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..train.precision import PRECISION_CHOICES, canonical_precision
from ..utils.envflags import (env_strict_choice, env_strict_flag,
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
    quant_calib_samples: int = 32  # int8 only (refused: ROADMAP A8)
    metrics_port: int = 0         # /healthz + /metrics port (0 = off)
    structure: bool = False       # raw-structure serving (submit_structure)
    md_skin: float = 0.3          # Verlet skin of trajectory sessions


def check_serving_precision(precision: Optional[str]) -> None:
    """Raise for a serving precision the port does not serve (int8)."""
    if precision == "int8":
        raise NotImplementedError(
            "Serving.precision 'int8' (post-training quantization) is not "
            "ported to hydragnn_tpu_torch yet (ROADMAP A8: the int8 "
            "serving tier); serve float32 or bfloat16")


def check_unported_serving_knobs(serving: ServingConfig,
                                 block: Dict[str, Any]) -> None:
    """Raise NotImplementedError naming A8 when the `Serving` block or the
    env asks for a replica fleet (hydragnn_tpu/serving/config.py
    `resolve_fleet`)."""
    fleet = block.get("fleet", {}) or {}
    if env_strict_int("HYDRAGNN_FLEET_REPLICAS",
                      int(fleet.get("replicas", 1) or 1)) > 1:
        raise NotImplementedError(
            "Serving.fleet.replicas / HYDRAGNN_FLEET_REPLICAS > 1 (a "
            "replica fleet) is not ported to hydragnn_tpu_torch yet "
            "(ROADMAP A8: serving)")


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
    one ServingConfig; raises for a knob the port does not serve."""
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
    out = ServingConfig(
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
    check_unported_serving_knobs(out, block)
    check_serving_precision(out.precision)
    return out
