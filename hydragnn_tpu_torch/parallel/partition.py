"""Deterministic node partitioning for sampled training on one giant graph
(counterpart: hydragnn_tpu/parallel/partition.py, whose maps, fingerprints
and messages this copy keeps bit for bit).

Every rank derives the same owner map from pure inputs, at any world
size, with no coordination; the feature store's byte accounting and the
historical-embedding cache's ownership read it. Two schemes:

* ``range``: owner(i) = i * P // N, contiguous id ranges (graphs whose id
  order carries locality, as ogbn-arxiv's time order does, get a
  meaningful cut for free);
* ``hash``: owner(i) = splitmix64(i ^ seed) % P, balanced and
  independent of the id order.

`partition_fingerprint` hashes exactly the map's inputs; the feature
store's cache key folds it in (preprocess/cache.feature_store_key), so a
re-partition never serves stale shards.

Not to be confused with `parallel/graph_parallel.partition_nodes`, the
block size of the graph slots' contiguous split (the JAX package has the
same two names).
"""
from __future__ import annotations

import hashlib
import json

import numpy as np

PARTITION_MODES = ("range", "hash")


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: platform-stable uint64 mixing."""
    with np.errstate(over="ignore"):
        z = x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def partition_nodes(num_nodes: int, num_partitions: int,
                    mode: str = "range", seed: int = 0) -> np.ndarray:
    """[num_nodes] int32 owner partition of each node: a pure function of
    the arguments, the same on every rank."""
    num_nodes = int(num_nodes)
    num_partitions = int(num_partitions)
    if num_nodes < 0:
        raise ValueError(f"num_nodes must be >= 0, got {num_nodes}")
    if num_partitions < 1:
        raise ValueError(
            f"num_partitions must be >= 1, got {num_partitions}")
    if mode not in PARTITION_MODES:
        raise ValueError(f"unknown partition mode '{mode}'; "
                         f"known: {PARTITION_MODES}")
    ids = np.arange(num_nodes, dtype=np.int64)
    if mode == "range":
        owner = (ids * num_partitions) // max(num_nodes, 1)
    else:
        mixed = _splitmix64(ids.astype(np.uint64)
                            ^ np.uint64(np.int64(seed) & 0x7FFFFFFFFFFFFFFF))
        owner = (mixed % np.uint64(num_partitions)).astype(np.int64)
    return owner.astype(np.int32)


def partition_fingerprint(num_nodes: int, num_partitions: int,
                          mode: str = "range", seed: int = 0) -> str:
    """sha256 over the inputs of `partition_nodes`: the map's identity for
    cache keys and cross-rank plan checks."""
    blob = json.dumps({"num_nodes": int(num_nodes),
                       "num_partitions": int(num_partitions),
                       "mode": str(mode), "seed": int(seed),
                       "scheme": "partition-v1"}, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


def cut_fraction(senders: np.ndarray, receivers: np.ndarray,
                 owner: np.ndarray) -> float:
    """Fraction of edges whose endpoints lie in different partitions (0.0
    for an empty edge list)."""
    senders = np.asarray(senders, np.int64).reshape(-1)
    receivers = np.asarray(receivers, np.int64).reshape(-1)
    if senders.size == 0:
        return 0.0
    owner = np.asarray(owner)
    return float(np.mean(owner[senders] != owner[receivers]))
