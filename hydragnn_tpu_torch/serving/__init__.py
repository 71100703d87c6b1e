"""Batched inference serving on the card (counterpart:
hydragnn_tpu/serving): the engine's request micro-batching over a bucket
ladder of CUDA graphs with its failure semantics (serving/engine.py), the
fleet on top (a replica router with per-replica isolation, hot swap and
a compile store of kernel libraries, serving/fleet.py), and the
continuous loop over both: a checkpoint publisher that canaries each new
BEST save into the fleet with rollback (serving/publish.py) and a
queue-depth autoscaler (serving/autoscale.py). An engine at
compute_dtype "int8" is the calibrated int8 tier (quant/), which a
fleet's TierPolicy routes beside float32 replicas. Multi-device shards
are not ported (ROADMAP A8)."""
from .autoscale import QueueDepthAutoscaler
from .config import (AutoscaleConfig, FleetConfig, PublishConfig,
                     ServingConfig, Structure, resolve_autoscale,
                     resolve_fleet, resolve_publish, resolve_serving)
from .engine import (CircuitOpenError, DeadlineExceededError,
                     InferenceEngine, QueueFullError, ServingError,
                     StructureSession, bucket_ladder, select_bucket)
from .fleet import (FleetUnavailableError, ReplicaRouter, SwapFailedError,
                    TierPolicy)
from .publish import CheckpointPublisher, adjudicate_window, pair_rel_err

__all__ = [
    "AutoscaleConfig",
    "CheckpointPublisher",
    "CircuitOpenError",
    "DeadlineExceededError",
    "FleetConfig",
    "FleetUnavailableError",
    "InferenceEngine",
    "PublishConfig",
    "QueueDepthAutoscaler",
    "QueueFullError",
    "ReplicaRouter",
    "ServingConfig",
    "ServingError",
    "Structure",
    "StructureSession",
    "SwapFailedError",
    "TierPolicy",
    "adjudicate_window",
    "bucket_ladder",
    "pair_rel_err",
    "resolve_autoscale",
    "resolve_fleet",
    "resolve_publish",
    "resolve_serving",
    "select_bucket",
]
