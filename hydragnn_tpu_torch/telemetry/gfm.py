"""GFM mixture-training telemetry (counterpart:
hydragnn_tpu/telemetry/gfm.py): per-head losses and per-member mixture
fractions as labelled gauges of the process registry, with the JAX
package's names, help strings and labels. No knob is read here."""
from __future__ import annotations

from typing import Dict, Optional

from .registry import get_registry


def record_gfm_epoch(train_losses: Dict[str, float],
                     val_losses: Optional[Dict[str, float]] = None,
                     mixture_frac: Optional[Dict[str, float]] = None
                     ) -> None:
    """One mixture epoch: `gfm_head_loss{head, split}` from the per-head
    train and val losses keyed by member name
    (train/gfm.GfmEpochAccumulator's means), and
    `gfm_mixture_frac{dataset}` from the epoch's measured fractions."""
    reg = get_registry()
    for name, v in train_losses.items():
        reg.gauge_set("gfm_head_loss", float(v),
                      help="per-head (= per member dataset) masked loss",
                      head=name, split="train")
    for name, v in (val_losses or {}).items():
        reg.gauge_set("gfm_head_loss", float(v),
                      help="per-head (= per member dataset) masked loss",
                      head=name, split="val")
    for name, v in (mixture_frac or {}).items():
        reg.gauge_set("gfm_mixture_frac", float(v),
                      help="fraction of the epoch's real graphs drawn "
                           "from this member dataset",
                      dataset=name)
