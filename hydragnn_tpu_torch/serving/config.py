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
        "bucket_multiple": 64      # shape rounding
    }

A `precision` other than float32 raises: the port serves float32 only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ..utils.envflags import env_strict_flag, env_strict_float, env_strict_int


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    enabled: bool = False
    max_batch_size: int = 32
    max_wait_ms: float = 5.0
    num_buckets: int = 0          # 0 = full ladder (1, 2, 4, ..., max)
    bucket_multiple: int = 64


def resolve_serving(config: Optional[Dict[str, Any]]) -> ServingConfig:
    block = (config or {}).get("Serving", {}) or {}
    if block.get("precision") not in (None, "float32"):
        raise NotImplementedError(
            f"Serving.precision={block['precision']!r}: the port serves "
            "float32 only so far (ROADMAP A8: reduced-precision and int8 "
            "tiers)")
    base = ServingConfig(
        enabled=bool(block.get("enabled", False)),
        max_batch_size=int(block.get("max_batch_size", 32)),
        max_wait_ms=float(block.get("max_wait_ms", 5.0)),
        num_buckets=int(block.get("num_buckets", 0)),
        bucket_multiple=int(block.get("bucket_multiple", 64)),
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
    )
