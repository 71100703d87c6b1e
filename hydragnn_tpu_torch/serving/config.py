"""Serving knobs: the `Serving` config block + HYDRAGNN_SERVE_* env layer
(counterpart: hydragnn_tpu/serving/config.py, `resolve_serving`).

Precedence per knob: env var over config block over default, with the
JAX package's defaults. This slice serves the engine core; the
failure-semantics, structure, int8, metrics and fleet knobs come with
ROADMAP item A8. Three of them change what JAX's run_prediction starts,
so asking for them raises NotImplementedError naming A8 (the config
block or the env, parsed as the JAX package parses them):
`metrics_port` > 0 (HYDRAGNN_SERVE_METRICS_PORT: the /metrics server),
`structure` (HYDRAGNN_SERVE_STRUCTURE: raw-structure serving) and
`fleet.replicas` > 1 (HYDRAGNN_FLEET_REPLICAS: a replica router).
`max_queue`, `deadline_ms` and `breaker_*` are left alone: JAX's offline
run_prediction holds them at their permissive defaults too.

    "Serving": {
        "enabled": false,          # engine path in run_prediction
        "max_batch_size": 32,      # requests coalesced per dispatch
        "max_wait_ms": 5.0,        # batching window for a lone request
        "num_buckets": 0,          # 0 = full capacity ladder
        "bucket_multiple": 64,     # shape rounding
        "precision": null          # serve-side compute dtype override
    }

`precision` (env HYDRAGNN_SERVE_PRECISION, parsed strictly: a typo warns
and keeps the config's value) takes the spellings of
train/precision.PRECISION_CHOICES: "float32" / "f32" / "fp32" or
"bfloat16" / "bf16". Unset, the engine inherits the train-side policy
(HYDRAGNN_PRECISION, then Architecture.dtype). "int8" raises: the int8
serving tier is ROADMAP A8.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..train.precision import PRECISION_CHOICES, canonical_precision
from ..utils.envflags import (env_strict_choice, env_strict_flag,
                              env_strict_float, env_strict_int)


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    enabled: bool = False
    max_batch_size: int = 32
    max_wait_ms: float = 5.0
    num_buckets: int = 0          # 0 = full ladder (1, 2, 4, ..., max)
    bucket_multiple: int = 64
    precision: Optional[str] = None  # None = inherit the train-side policy


def check_serving_precision(precision: Optional[str]) -> None:
    """Raise for a serving precision the port does not serve (int8)."""
    if precision == "int8":
        raise NotImplementedError(
            "Serving.precision 'int8' (post-training quantization) is not "
            "ported to hydragnn_tpu_torch yet (ROADMAP A8: the int8 "
            "serving tier); serve float32 or bfloat16")


def check_unported_serving_knobs(block: Dict[str, Any]) -> None:
    """Raise NotImplementedError naming A8 when the `Serving` block or the
    env asks for the metrics server, raw-structure serving or a replica
    fleet (hydragnn_tpu/serving/config.py `resolve_serving`,
    `resolve_fleet`)."""
    fleet = block.get("fleet", {}) or {}
    knobs = [
        (env_strict_int("HYDRAGNN_SERVE_METRICS_PORT",
                        int(block.get("metrics_port", 0) or 0)) > 0,
         "Serving.metrics_port / HYDRAGNN_SERVE_METRICS_PORT (the /metrics "
         "server)"),
        (env_strict_flag("HYDRAGNN_SERVE_STRUCTURE",
                         bool(block.get("structure", False))),
         "Serving.structure / HYDRAGNN_SERVE_STRUCTURE (raw-structure "
         "serving)"),
        (env_strict_int("HYDRAGNN_FLEET_REPLICAS",
                        int(fleet.get("replicas", 1) or 1)) > 1,
         "Serving.fleet.replicas / HYDRAGNN_FLEET_REPLICAS > 1 (a replica "
         "fleet)"),
    ]
    for on, what in knobs:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to hydragnn_tpu_torch yet (ROADMAP "
                "A8: serving)")


def resolve_serving(config: Optional[Dict[str, Any]]) -> ServingConfig:
    block = (config or {}).get("Serving", {}) or {}
    check_unported_serving_knobs(block)
    base = ServingConfig(
        enabled=bool(block.get("enabled", False)),
        max_batch_size=int(block.get("max_batch_size", 32)),
        max_wait_ms=float(block.get("max_wait_ms", 5.0)),
        num_buckets=int(block.get("num_buckets", 0)),
        bucket_multiple=int(block.get("bucket_multiple", 64)),
        precision=canonical_precision(block.get("precision")),
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
        precision=env_strict_choice("HYDRAGNN_SERVE_PRECISION",
                                    PRECISION_CHOICES, base.precision),
    )
    check_serving_precision(out.precision)
    return out
