"""The port's hand-written CUDA kernels, one wrapper module each:

* `segment.segment_sum`       — csrc/segment_sum.cu
* `nbr.nbr_aggregate`         — csrc/nbr_aggregate.cu
* `fused_mp.pna_edge_accumulators` — csrc/pna_edge_aggregate.cu

Each wrapper launches its kernel for CUDA tensors, runs its plain PyTorch
version for CPU tensors, and counts its launches in the module's
`launches` integer.
"""
from __future__ import annotations

from typing import Dict

KERNEL_MODULES = {"segment_sum": "segment", "nbr_aggregate": "nbr",
                  "pna_edge_aggregate": "fused_mp"}


def _module(name):
    import importlib
    return importlib.import_module(f"{__name__}.{KERNEL_MODULES[name]}")


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches so far in this process}."""
    return {name: _module(name).launches for name in KERNEL_MODULES}


def reset_launch_counts() -> None:
    for name in KERNEL_MODULES:
        _module(name).launches = 0
