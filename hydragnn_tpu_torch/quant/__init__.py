"""Calibrated int8 post-training quantization for the serving tier
(counterpart: hydragnn_tpu/quant). The serving engine's
``compute_dtype="int8"`` and a fleet's tier routing
(serving/fleet.TierPolicy) compose three pieces:

* ``calibrate``: a deterministic pass collecting per-input-channel
  activation ranges of every encoder-conv Dense (the same set gives
  bitwise the same scales, whatever its order or sharding);
* ``make_quantized_forward``: symmetric per-channel int8 weights and
  activations, exact int32 accumulation (``torch._int_mm``) and one
  float32 multiply a product, the weights quantized inside the forward
  from the live parameters;
* ``distill_heads``: the float32 decoder heads fine-tuned against the
  float32 teacher through the quantized forward.
"""
from .calibrate import (CalibrationScales, calibrate, merge_calibrations,
                        scales_digest)
from .distill import distill_heads
from .ptq import int8_dense, make_quantized_forward

__all__ = [
    "CalibrationScales", "calibrate", "merge_calibrations",
    "scales_digest", "int8_dense", "make_quantized_forward",
    "distill_heads",
]
