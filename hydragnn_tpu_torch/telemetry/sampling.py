"""Sampled-training telemetry (counterpart:
hydragnn_tpu/telemetry/sampling.py): the sampler's throughput, the
historical cache's serves and the feature store's fetched bytes as metrics
of the process registry, with the JAX package's names, kinds, labels and
help strings. No knob is read here; callers pass plain values. The
registry is thread-safe, so the sampling loader's producer thread reports
here too."""
from __future__ import annotations

from typing import Dict

from .registry import get_registry


def record_sampled_batch(num_seeds: int, num_nodes: int, hist_served: int,
                         fetch_stats: Dict[str, int]) -> None:
    """One sampled minibatch: seeds and node slots, the slots served from
    the historical cache, and the store's cumulative local and remote
    fetched bytes (gauges: `fetch_stats` is cumulative)."""
    reg = get_registry()
    reg.counter_inc("sampler_batches_total",
                    help="sampled minibatches built")
    reg.counter_inc("sampler_seed_nodes_total", float(num_seeds),
                    help="seed nodes trained on")
    reg.counter_inc("sampler_subgraph_nodes_total", float(num_nodes),
                    help="sampled subgraph node occurrences")
    reg.counter_inc("sampler_hist_served_nodes_total", float(hist_served),
                    help="occurrences served from the historical "
                         "embedding cache instead of expansion")
    reg.gauge_set("sampler_fetched_bytes", float(fetch_stats["local_bytes"]),
                  help="cumulative feature-store gather bytes",
                  kind="local")
    reg.gauge_set("sampler_fetched_bytes",
                  float(fetch_stats["remote_bytes"]),
                  help="cumulative feature-store gather bytes",
                  kind="remote")


def record_hist_refresh(staleness_mean: float, hist_frac: float) -> None:
    """One historical-mode step's cache health, read on the host from the
    step's metrics: the mean version staleness of the served rows and the
    fraction of the batch's slots served stale."""
    reg = get_registry()
    reg.gauge_set("sampler_hist_staleness_steps", float(staleness_mean),
                  help="mean steps since refresh of served hist rows")
    reg.gauge_set("sampler_hist_served_frac", float(hist_frac),
                  help="fraction of batch node slots served from the "
                       "historical cache")
