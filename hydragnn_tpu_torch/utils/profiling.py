"""Latency summary shared by the serving engine, the fleet and the
publisher (counterpart: hydragnn_tpu/utils/profiling.py
`latency_percentiles`)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def latency_percentiles(latencies_s, percentiles=(50, 95, 99)
                        ) -> Dict[str, float]:
    """{"p50_ms", "p95_ms", "p99_ms", "mean_ms", "count"} from latencies
    in seconds. The full key set is always there: no latencies give
    zeros with `count` 0."""
    lat = np.asarray(list(latencies_s), np.float64)
    out: Dict[str, float] = {f"p{int(q)}_ms": 0.0 for q in percentiles}
    out["mean_ms"] = 0.0
    out["count"] = 0
    if lat.size == 0:
        return out
    for q in percentiles:
        out[f"p{int(q)}_ms"] = float(np.percentile(lat, q) * 1e3)
    out["mean_ms"] = float(lat.mean() * 1e3)
    out["count"] = int(lat.size)
    return out
