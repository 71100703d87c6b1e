"""Host-side triplet enumeration for DimeNet's directional message
passing (counterpart: hydragnn_tpu/graphs/triplets.py).

A triplet (k -> j -> i) is a pair of edges (e1 = k -> j, e2 = j -> i)
with k != i; `idx_kj` / `idx_ji` index the batch's edge arrays. Triplets
are enumerated in numpy when a batch is collated, into [T] index arrays
padded to a budget fixed once for the run, so every batch of a run keeps
one shape (one CUDA graph a step kind). Padding triplets point at the
last edge, the padding edge, with `triplet_mask` False: bitwise the JAX
package's tables.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .batch import GraphBatch


def count_triplets(senders: np.ndarray, receivers: np.ndarray) -> int:
    """The triplet count of one graph's edges, for budget sizing: the
    pairs sum_e deg_in(sender(e)) less the k == i back-tracks, counted
    once for each (sender, receiver) pair whose reverse edge exists."""
    if len(senders) == 0:
        return 0
    n = int(max(senders.max(initial=-1), receivers.max(initial=-1)) + 1)
    deg_in = np.bincount(receivers, minlength=n)   # edges k->j per node j
    pairs = int(deg_in[senders].sum())
    edge_set = set(zip(senders.tolist(), receivers.tolist()))
    backtracks = sum(1 for s, r in edge_set if (r, s) in edge_set)
    return pairs - backtracks


def triplet_budget(samples: Sequence, graphs_per_batch: int,
                   multiple: int = 128) -> int:
    """Room for `graphs_per_batch` of the samples' most triplet-rich graph
    and one padding triplet, rounded up to `multiple`."""
    worst = max(count_triplets(s.senders, s.receivers) for s in samples)
    t = worst * graphs_per_batch + 1
    return int(np.ceil(t / multiple) * multiple)


def _padded(batch: GraphBatch, kj: np.ndarray, ji: np.ndarray,
            budget: int) -> GraphBatch:
    """`batch` with the triplet tables of (kj, ji) padded to `budget`."""
    e = batch.senders.shape[0]
    t = len(kj)
    if t > budget:
        raise ValueError(f"triplet count {t} exceeds budget {budget}")
    idx_kj = np.full(budget, e - 1, np.int32)
    idx_ji = np.full(budget, e - 1, np.int32)
    mask = np.zeros(budget, bool)
    idx_kj[:t] = kj
    idx_ji[:t] = ji
    mask[:t] = True
    dev = batch.senders.device
    return dataclasses.replace(
        batch, idx_kj=torch.from_numpy(idx_kj).to(dev),
        idx_ji=torch.from_numpy(idx_ji).to(dev),
        triplet_mask=torch.from_numpy(mask).to(dev))


def add_triplets(batch: GraphBatch, budget: int) -> GraphBatch:
    """The batch with idx_kj / idx_ji / triplet_mask enumerated from its
    real edges and padded to `budget`."""
    send = batch.senders.cpu().numpy()
    recv = batch.receivers.cpu().numpy()
    real = np.nonzero(batch.edge_mask.cpu().numpy())[0]
    kj, ji = sample_triplets(send[real], recv[real])
    return _padded(batch, real[kj], real[ji], budget)


def sample_triplets(senders: np.ndarray, receivers: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """One sample's local triplet edge pairs (kj, ji): for each edge
    e2 = j -> i in order, the edges k -> j (k != i) in stable receiver
    order."""
    n = int(max(senders.max(initial=-1), receivers.max(initial=-1)) + 1)
    order = np.argsort(receivers, kind="stable")
    sorted_recv = receivers[order]
    starts = np.searchsorted(sorted_recv, np.arange(n))
    ends = np.searchsorted(sorted_recv, np.arange(n), side="right")
    kj_list, ji_list = [], []
    for e2 in range(len(senders)):
        j, i = senders[e2], receivers[e2]
        cand = order[starts[j]:ends[j]]
        cand = cand[senders[cand] != i]
        kj_list.append(cand)
        ji_list.append(np.full(len(cand), e2, np.int64))
    if kj_list:
        return (np.concatenate(kj_list).astype(np.int64),
                np.concatenate(ji_list).astype(np.int64))
    return np.zeros(0, np.int64), np.zeros(0, np.int64)


class TripletTransform:
    """The loaders' `batch_transform` for DimeNet: each sample's triplets
    are enumerated once and cached by content; a batch only offsets and
    concatenates them. Called without the samples it enumerates the
    batch's edges (`add_triplets`)."""

    def __init__(self, samples: Sequence, graphs_per_batch: int):
        self.budget = triplet_budget(samples, graphs_per_batch)
        self._cache: dict = {}

    def _lookup(self, s) -> Tuple[np.ndarray, np.ndarray]:
        # a content key: datasets that make a fresh sample object on every
        # access would alias reused ids
        send = np.asarray(s.senders)
        recv = np.asarray(s.receivers)
        key = (send.shape[0], hash(send.tobytes()), hash(recv.tobytes()))
        hit = self._cache.get(key)
        if hit is None:
            hit = sample_triplets(send, recv)
            self._cache[key] = hit
        return hit

    def __call__(self, batch: GraphBatch, samples: Optional[Sequence] = None
                 ) -> GraphBatch:
        if samples is None:
            return add_triplets(batch, self.budget)
        kj_parts, ji_parts = [], []
        eo = 0
        for s in samples:
            kj, ji = self._lookup(s)
            kj_parts.append(kj + eo)
            ji_parts.append(ji + eo)
            eo += s.num_edges
        kj = np.concatenate(kj_parts) if kj_parts else np.zeros(0, np.int64)
        ji = np.concatenate(ji_parts) if ji_parts else np.zeros(0, np.int64)
        return _padded(batch, kj, ji, self.budget)


def make_triplet_transform(samples: Sequence, graphs_per_batch: int):
    return TripletTransform(samples, graphs_per_batch)


def maybe_triplet_transform(model_type: str, samples: Sequence,
                            graphs_per_batch: int):
    """The triplet transform for DimeNet, None for every other model: the
    one helper run_training and run_prediction share."""
    if model_type != "DimeNet":
        return None
    return TripletTransform(samples, graphs_per_batch)
