"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU: a missing
GPU is an error, never a silent fallback. Float32 matmuls and convolutions
are pinned to full float32 (no TF32), the precision the JAX reference
computes its dense layers in, and bf16 matmuls to float32 accumulation
(no reduced-precision reductions: the mixed-precision policy sums in
float32)."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hydragnn_tpu_torch: device 'cuda' was requested but no CUDA "
                "device is available — pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         "'cpu'")
    return dev
