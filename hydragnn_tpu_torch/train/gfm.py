"""The head-masked multi-task step of multi-dataset GFM training
(counterpart: hydragnn_tpu/train/gfm.py).

A mixture batch (parallel/multidataset.GfmMixtureLoader) carries each
graph's member `dataset_id`; train/loss.multihead_loss masks head i's
loss to member i's graphs (`head_loss_mask`), so the conv stack runs
once over the packed mixture and the mixture changes the data, never
the captured step. This module is the layer over it:

* `apply_head_weights` puts the resolved per-head weights
  (utils/envflags.resolve_gfm) into the config's `task_weights`; every
  step factory (single device, SPMD with ZeRO, the pipeline) reads them
  from there;
* `make_gfm_train_step` / `make_gfm_eval_step` are the single-device
  factories over that config, with the head-dataset binding checked:
  on the card one CUDA graph for each batch signature
  (train/step_graphs.py), which a mixture keeps to one;
* `mixture_graph_counts` and `GfmEpochAccumulator` weigh each batch's
  masked per-head loss by its member's graphs, so a batch without a
  member's graphs (task loss 0.0) does not dilute that member's mean.

No environment is read here: callers resolve the knobs once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from ..config.config import ModelConfig
from ..graphs.batch import GraphBatch
from .loss import head_loss_mask  # noqa: F401  (the masking itself)
from .train_step import make_eval_step, make_train_step


def apply_head_weights(cfg: ModelConfig,
                       head_weights: Optional[Sequence[float]]
                       ) -> ModelConfig:
    """`cfg` with `task_weights` replaced by the per-head weights (a new
    frozen config; `cfg` itself for None)."""
    if head_weights is None:
        return cfg
    hw = tuple(float(w) for w in head_weights)
    if len(hw) != len(cfg.heads):
        raise ValueError(
            f"got {len(hw)} GFM head weights for {len(cfg.heads)} heads "
            "— one combine weight per head (HYDRAGNN_GFM_HEAD_WEIGHTS / "
            "Training.Gfm.head_weights)")
    return dataclasses.replace(cfg, task_weights=hw)


def _check_gfm_heads(cfg: ModelConfig, num_datasets: Optional[int]) -> None:
    if num_datasets is not None and len(cfg.heads) != num_datasets:
        raise ValueError(
            f"GFM step binds head i to member dataset i but the model "
            f"defines {len(cfg.heads)} heads for {num_datasets} member "
            "datasets — counts must match (docs/gfm.md)")


def make_gfm_train_step(model, cfg: ModelConfig, tx, *,
                        head_weights: Optional[Sequence[float]] = None,
                        num_datasets: Optional[int] = None,
                        loss_name: str = "mse", **kwargs):
    """`make_train_step` over the head-weighted config. On a batch
    without `dataset_id` it is the plain multihead step."""
    _check_gfm_heads(cfg, num_datasets)
    return make_train_step(model, apply_head_weights(cfg, head_weights),
                           tx, loss_name=loss_name, **kwargs)


def make_gfm_eval_step(model, cfg: ModelConfig, *,
                       head_weights: Optional[Sequence[float]] = None,
                       num_datasets: Optional[int] = None,
                       loss_name: str = "mse", **kwargs):
    """The eval twin: each `task_<i>` metric is the masked mean over head
    i's member."""
    _check_gfm_heads(cfg, num_datasets)
    return make_eval_step(model, apply_head_weights(cfg, head_weights),
                          loss_name=loss_name, **kwargs)


def _host(t) -> np.ndarray:
    return np.asarray(t.cpu() if hasattr(t, "cpu") else t)


def mixture_graph_counts(batch: GraphBatch, num_heads: int) -> np.ndarray:
    """The real graphs of each member in one mixture batch, [G] or
    stacked [D, G]."""
    ids = _host(batch.dataset_id).reshape(-1)
    real = _host(batch.graph_mask).reshape(-1)
    counts = np.zeros(num_heads, np.int64)
    for h in range(num_heads):
        counts[h] = int(np.sum(real & (ids == h)))
    return counts


class GfmEpochAccumulator:
    """Count-weighted per-head means over an epoch of mixture batches:
    `update(batch, metrics)` after each step, `summary()` at the end ->
    {"head_losses": {name: mean}, "mixture_frac": {name: measured
    share of the real graphs}}."""

    def __init__(self, member_names: Sequence[str]):
        self.names = tuple(member_names)
        self._loss_sum = np.zeros(len(self.names), np.float64)
        self._count = np.zeros(len(self.names), np.int64)

    def update(self, batch: GraphBatch, metrics: Dict) -> None:
        counts = mixture_graph_counts(batch, len(self.names))
        for i in range(len(self.names)):
            li = metrics.get(f"task_{i}")
            if li is None:
                continue
            self._loss_sum[i] += float(li) * counts[i]
            self._count[i] += counts[i]

    @property
    def total_graphs(self) -> int:
        """Real graphs seen so far, over every member."""
        return int(self._count.sum())

    def summary(self) -> Dict[str, Dict[str, float]]:
        total = max(int(self._count.sum()), 1)
        return {
            "head_losses": {
                n: self._loss_sum[i] / max(int(self._count[i]), 1)
                for i, n in enumerate(self.names)},
            "mixture_frac": {
                n: int(self._count[i]) / total
                for i, n in enumerate(self.names)},
        }
