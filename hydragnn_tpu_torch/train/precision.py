"""Mixed-precision policy resolution (counterpart:
hydragnn_tpu/train/precision.py): which compute dtype a step or engine
runs in, decided once when it is built.

Precedence, most specific first:

1. an explicit override at construction (`compute_dtype=`, or the serving
   side's `Serving.precision` / HYDRAGNN_SERVE_PRECISION);
2. HYDRAGNN_PRECISION, parsed strictly (a typo warns and falls through);
3. Architecture.dtype;
4. float32.

The policy itself — bf16 compute on bf16 copies of float32 master
parameters, float32 sums and losses — is train/train_step.py's casting
and ops/segment.py's `_accum_f32`.

The port runs float32 and bfloat16. int8 is a serving-only mode: the
train side warns and uses float32 (`canonical_or_f32`) and the step
factories raise on it. The other numpy dtype names (float16, float64,
...) pass through canonicalization and resolution as the JAX package
passes them; `check_ported_precision` refuses one, naming ROADMAP A5,
only where a resolved compute dtype is used: a train or eval step's
(`train_step._resolve_compute_dtype`, run_training) and the engine's
when an engine is built (`serving/engine.py`).
"""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from ..utils.envflags import env_strict_choice

PRECISION_CHOICES = {
    "float32": "float32", "f32": "float32", "fp32": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "i8": "int8",
}

_log = logging.getLogger("hydragnn_tpu_torch")


def canonical_precision(name) -> Optional[str]:
    """Canonical dtype name for `name`, or None when unrecognized."""
    if name is None:
        return None
    key = str(name).strip().lower()
    if not key:
        return None
    if key in PRECISION_CHOICES:
        return PRECISION_CHOICES[key]
    try:
        # a dtype name the JAX package passes through (float16, ...)
        return str(np.dtype(key).name)
    except TypeError:
        return None


PORTED_PRECISIONS = ("float32", "bfloat16", "int8")


def check_ported_precision(name: str) -> str:
    """`name` (a resolved compute dtype) where the port computes in it;
    NotImplementedError naming ROADMAP A5 for the other dtype names the
    JAX package passes through (float16, float64, ...)."""
    if name not in PORTED_PRECISIONS:
        raise NotImplementedError(
            f"precision {name!r} is not ported to hydragnn_tpu_torch "
            "(ROADMAP A5: the port computes in float32 and bfloat16)")
    return name


def canonical_or_f32(name) -> str:
    """Canonical dtype name, or warn-and-float32 for an unrecognized value
    and for int8 (serving-only: the train side would cast the float
    parameters to int8)."""
    if name is None:
        return "float32"
    canon = canonical_precision(name)
    if canon is None:
        _log.warning("Architecture.dtype %r is not a recognized precision; "
                     "using float32", name)
        return "float32"
    if canon == "int8":
        _log.warning("Architecture.dtype 'int8' is serving-only "
                     "(post-training quantization); the train-side policy "
                     "uses float32")
        return "float32"
    return canon


def resolve_precision(cfg_dtype=None, override=None) -> str:
    """The compute-dtype name a step or engine factory bakes in:
    `override`, then HYDRAGNN_PRECISION, then `cfg_dtype`
    (Architecture.dtype), then float32. An unrecognized override warns
    and falls through."""
    name = canonical_precision(override)
    if override is not None and name is None:
        _log.warning("compute dtype override %r is not a recognized "
                     "precision (%s); falling through", override,
                     sorted(set(PRECISION_CHOICES)))
    if name is not None:
        return name
    name = env_strict_choice("HYDRAGNN_PRECISION", PRECISION_CHOICES, None)
    if name is not None:
        return name
    return canonical_or_f32(cfg_dtype)
