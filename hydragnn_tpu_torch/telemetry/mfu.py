"""MFU: the peak-FLOPs table of the card and the achieved / peak gauge
(counterpart: hydragnn_tpu/telemetry/mfu.py, whose table holds TPUs
only).

The table is keyed by `torch.cuda.get_device_name()` and holds one peak
a compute dtype, each from the card's public data sheet. float32 is the
CUDA-core peak: the port runs float32 products with TF32 off
(utils/devices.py), not on the tensor cores. An unknown card gets no
peak: `achieved_and_mfu` then reports the achieved rate and mfu None,
and logs the name once (the JAX package falls back to a TPU v5e figure;
a TPU's peak is no denominator for this card).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

# {device name: {compute dtype: peak FLOP/s}}
PEAK_FLOPS: Dict[str, Dict[str, float]] = {
    # NVIDIA H100 SXM5 80GB data sheet: dense BF16 tensor core 989.4
    # TFLOPS (1,979 with sparsity), FP32 (CUDA cores) 66.9 TFLOPS
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989.4e12, "float32": 66.9e12},
}

_log = logging.getLogger("hydragnn_tpu_torch")
_UNKNOWN_LOGGED = set()


def _canonical(compute_dtype) -> str:
    return ("bfloat16" if compute_dtype in ("bfloat16", "bf16")
            else "float32")


def peak_flops(device_kind: str, compute_dtype: str = "float32",
               peak_override: float = 0.0) -> Optional[float]:
    """The peak FLOP/s of `device_kind` at `compute_dtype`; an override
    is taken as it is (the dtype's own peak); None for a card the table
    does not hold."""
    if peak_override:
        return float(peak_override)
    row = PEAK_FLOPS.get(device_kind)
    if row is None:
        if device_kind not in _UNKNOWN_LOGGED:
            _UNKNOWN_LOGGED.add(device_kind)
            _log.warning("telemetry: no peak FLOP/s for device %r; MFU "
                         "is not reported (pass peak_override)",
                         device_kind)
        return None
    return row[_canonical(compute_dtype)]


def achieved_and_mfu(flops_per_step: Optional[float], steps: int,
                     wall_s: float, backend: str, device_kind: str,
                     compute_dtype: str = "float32",
                     peak_override: float = 0.0
                     ) -> Tuple[Optional[float], Optional[float]]:
    """(achieved FLOP/s, mfu) of `steps` steps over `wall_s` seconds of
    dispatch and execution. `achieved` on every backend; `mfu` only on
    the card (None on the CPU, for unusable inputs and for an unknown
    card)."""
    if flops_per_step is None or wall_s <= 0.0 or steps <= 0:
        return None, None
    achieved = flops_per_step * steps / wall_s
    if not backend or backend.startswith("cpu"):
        return achieved, None
    peak = peak_flops(device_kind, compute_dtype, peak_override)
    return achieved, (achieved / peak if peak else None)
