"""Serving knobs: the `Serving` config block + HYDRAGNN_SERVE_* env layer
(counterpart: hydragnn_tpu/serving/config.py, `resolve_serving`).

Precedence per knob: env var over config block over default, with the
JAX package's defaults. This slice serves the engine core; the
failure-semantics, structure, int8, metrics and fleet knobs come with
ROADMAP item A8.

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


def resolve_serving(config: Optional[Dict[str, Any]]) -> ServingConfig:
    block = (config or {}).get("Serving", {}) or {}
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
