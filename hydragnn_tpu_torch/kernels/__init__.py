"""The port's hand-written CUDA kernels, one wrapper module each:

* `segment.segment_sum`       — csrc/segment_sum.cu
* `nbr.nbr_aggregate`         — csrc/nbr_aggregate.cu
* `fused_mp.pna_edge_accumulators` — csrc/pna_edge_aggregate.cu
* `fused_mp.filter_scatter`   — csrc/filter_scatter.cu
* `nbr.nbr_aggregate_bwd`, `fused_mp.pna_edge_bwd` (the two PNA
  Functions' backwards) — csrc/pna_backward.cu

Each wrapper launches its kernel for CUDA tensors, runs its plain PyTorch
version for CPU tensors, and counts its launches in an integer of its
module; `filter_scatter` counts its forward calls and the calls its
backward makes apart; a PNA backward counts the two kernels of its two
passes, under `<kernel>_backward`.

A wrapper called while a CUDA graph is captured counts the launch it
records; `train/step_graphs.py` takes a capture's count back and adds it
again at each replay, so the counters count the kernels the card runs.
Every update of a counter holds `COUNTS_LOCK`, and the replays' additions
are also summed apart (`replayed_counts`), so that a capture on one thread
takes back its own wrapper calls and not the replays other threads (a
fleet's replicas) add meanwhile.
"""
from __future__ import annotations

import threading
from typing import Dict

# kernel name -> (wrapper module, launch counter in it)
KERNEL_COUNTERS = {
    "segment_sum": ("segment", "launches"),
    "nbr_aggregate": ("nbr", "launches"),
    "pna_edge_aggregate": ("fused_mp", "launches"),
    "filter_scatter": ("fused_mp", "filter_launches"),
    "filter_scatter_backward": ("fused_mp", "filter_backward_launches"),
    "nbr_aggregate_backward": ("nbr", "backward_kernel_launches"),
    "pna_edge_aggregate_backward": ("fused_mp", "backward_kernel_launches"),
    "nbr_aggregate_bf16": ("nbr", "bf16_launches"),
    "pna_edge_aggregate_bf16": ("fused_mp", "bf16_launches"),
    "filter_scatter_bf16": ("fused_mp", "filter_bf16_launches"),
    "filter_scatter_backward_bf16": ("fused_mp",
                                     "filter_backward_bf16_launches"),
    "nbr_aggregate_backward_bf16": ("nbr", "backward_kernel_bf16_launches"),
    "pna_edge_aggregate_backward_bf16": ("fused_mp",
                                         "backward_kernel_bf16_launches"),
}


COUNTS_LOCK = threading.RLock()
# launches added by graph replays since the process started (never reset)
_replayed: Dict[str, int] = dict.fromkeys(KERNEL_COUNTERS, 0)


def _module(name):
    import importlib
    return importlib.import_module(f"{__name__}.{KERNEL_COUNTERS[name][0]}")


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches so far in this process}."""
    with COUNTS_LOCK:
        return {name: getattr(_module(name), attr)
                for name, (_, attr) in KERNEL_COUNTERS.items()}


def set_launch_counts(counts: Dict[str, int]) -> None:
    with COUNTS_LOCK:
        for name, (_, attr) in KERNEL_COUNTERS.items():
            setattr(_module(name), attr, counts[name])


def add_launch_counts(counts: Dict[str, int]) -> None:
    """A graph replay's launches."""
    with COUNTS_LOCK:
        for name, (_, attr) in KERNEL_COUNTERS.items():
            if counts[name]:
                mod = _module(name)
                setattr(mod, attr, getattr(mod, attr) + counts[name])
                _replayed[name] += counts[name]


def replayed_counts() -> Dict[str, int]:
    """{kernel name: launches added by graph replays in this process}."""
    with COUNTS_LOCK:
        return dict(_replayed)


def counts_mark():
    """Where a capture starts counting: (launch counts, replayed counts)."""
    with COUNTS_LOCK:
        return launch_counts(), replayed_counts()


def take_back_since(mark) -> Dict[str, int]:
    """The wrapper calls made since `mark`, taken back from the counters
    and returned (a capture's own launches); what replays added meanwhile
    stays counted. On the card only the capturing thread calls wrappers
    then: captures and their warm-ups hold the device's capture lock, and
    other threads replay."""
    before, replayed = mark
    with COUNTS_LOCK:
        now, rep = launch_counts(), replayed_counts()
        others = {k: rep[k] - replayed[k] for k in rep}
        set_launch_counts({k: before[k] + others[k] for k in now})
    return {k: now[k] - before[k] - others[k] for k in now}


def reset_launch_counts() -> None:
    set_launch_counts(dict.fromkeys(KERNEL_COUNTERS, 0))
