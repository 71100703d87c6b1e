"""Fixed-shape graph data loader (counterpart:
hydragnn_tpu/datasets/loader.py::GraphDataLoader, its fixed-shape,
single-shard path).

Every batch of a run has one padded shape, computed once from the
dataset: room for `batch_size` of the largest graphs, nodes and edges
each rounded by `BucketSpec(multiple=64)`, and `batch_size + 1` graph
slots. An epoch's order is a pure function of (seed, epoch):
`np.random.RandomState(seed + epoch)` shuffles the indices, so every run
and every resumed epoch replays it. `drop_last` defaults to `shuffle` and
never drops an epoch to zero batches. With `neighbor_format` each batch
carries the dense [N, K] neighbor tables, K pinned once from the dataset.
Batches are numpy-built on the host, bitwise what the JAX loader builds,
and handed out as GraphBatches of CPU tensors; non-shuffled loaders
(validation, test) collate once and replay.

Budget packing, device-stacked shards, background collation and the
batch cache are not ported (run_training refuses their knobs).
"""
from __future__ import annotations

import math
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..graphs.batch import (BucketSpec, GraphBatch, GraphSample, collate,
                            neighbor_budget_for_dataset, with_neighbor_format)


class DatasetInvariants(NamedTuple):
    """Dataset-level statistics that fix the batch shape."""
    max_nodes: int
    max_edges: int


def dataset_invariants(samples: Sequence) -> DatasetInvariants:
    """One pass over `samples` for (max nodes, max edges)."""
    return DatasetInvariants(max((s.num_nodes for s in samples), default=0),
                             max((s.num_edges for s in samples), default=0))


def padded_budgets(samples: Sequence, graphs: int) -> Tuple[int, int]:
    """(n_node, n_edge): room for `graphs` of the largest graphs of
    `samples`, each rounded up by BucketSpec(multiple=64)."""
    inv = dataset_invariants(samples)
    bucket = BucketSpec(multiple=64)
    return (bucket.bucket(inv.max_nodes * graphs + 1),
            bucket.bucket(inv.max_edges * graphs + 1))


class GraphDataLoader:
    def __init__(self, dataset: Sequence[GraphSample], batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: Optional[bool] = None,
                 n_node: Optional[int] = None, n_edge: Optional[int] = None,
                 neighbor_format: bool = False,
                 neighbor_k: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = shuffle if drop_last is None else drop_last
        if n_node is None or n_edge is None:
            n_node, n_edge = padded_budgets(dataset, batch_size)
        self.n_node = n_node
        self.n_edge = n_edge
        self.n_graph = batch_size + 1
        self.neighbor_k = None
        if neighbor_format:
            self.neighbor_k = neighbor_k or neighbor_budget_for_dataset(
                dataset)
        self._cache: Optional[List[GraphBatch]] = None

    def set_epoch(self, epoch: int):
        """Reseed the epoch's shuffle: the order is a pure function of
        (seed, epoch)."""
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            # never drop down to zero batches: a dataset smaller than one
            # batch still yields one padded batch
            return max(n // self.batch_size, 1 if n else 0)
        return math.ceil(n / self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx

    def _selections(self) -> List[Tuple[int, ...]]:
        """The epoch's batch index tuples, in yield order."""
        order = self._order()
        return [tuple(int(i) for i in
                      order[ib * self.batch_size:(ib + 1) * self.batch_size])
                for ib in range(len(self))]

    def _build_batch(self, sel: Tuple[int, ...]) -> GraphBatch:
        b = collate([self.dataset[i] for i in sel], n_node=self.n_node,
                    n_edge=self.n_edge, n_graph=self.n_graph)
        if self.neighbor_k is not None:
            b = with_neighbor_format(b, k=self.neighbor_k)
        return b

    def __iter__(self) -> Iterator[GraphBatch]:
        if not self.shuffle:
            # validation/test batches are the same every epoch
            if self._cache is None:
                self._cache = [self._build_batch(sel)
                               for sel in self._selections()]
            yield from self._cache
            return
        for sel in self._selections():
            yield self._build_batch(sel)
