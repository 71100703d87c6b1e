"""Output post-processing (counterpart:
hydragnn_tpu/postprocess/postprocess.py, `output_denormalize`)."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def output_denormalize(y_minmax: Sequence[Sequence[float]],
                       true_values: List[np.ndarray],
                       predicted_values: List[np.ndarray]):
    """Invert min-max normalization per head."""
    out_t, out_p = [], []
    for ih, (t, p) in enumerate(zip(true_values, predicted_values)):
        ymin, ymax = float(y_minmax[ih][0]), float(y_minmax[ih][1])
        scale = ymax - ymin
        out_t.append(t * scale + ymin)
        out_p.append(p * scale + ymin)
    return out_t, out_p
