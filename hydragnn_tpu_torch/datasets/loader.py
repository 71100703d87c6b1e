"""Graph data loader (counterpart:
hydragnn_tpu/datasets/loader.py::GraphDataLoader, its single-shard,
single-process path, fixed-shape or budget-packed).

Every batch of a run has one padded shape, computed once from the
dataset. Fixed-shape: room for `batch_size` of the largest graphs, nodes
and edges each rounded by `BucketSpec(multiple=64)`, and `batch_size + 1`
graph slots. Packed (`packing=True`): the `graphs.packing.PackBudget`'s
shape, sized for `batch_size` average graphs, each batch one bin of a
variable number of graphs; an epoch's bins are `pack_order`'s plan of its
order, built once an epoch. An epoch's order is a pure function of
(seed, epoch):
`np.random.RandomState(seed + epoch)` shuffles the indices, so every run
and every resumed epoch replays it. `drop_last` defaults to `shuffle` and
never drops an epoch to zero batches. `batch_transform(batch, samples)`
(or `batch_transform(batch)`, by its arity), e.g. DimeNet's
`graphs.triplets.TripletTransform`, rewrites each collated batch before
the neighbor tables are built. With `neighbor_format` each batch
carries the dense [N, K] neighbor tables, K pinned once from the dataset.
Batches are numpy-built on the host, bitwise what the JAX loader builds,
and handed out as GraphBatches of CPU tensors; non-shuffled loaders
(validation, test) collate once and replay.

Every sample is fetched through `fetch_samples`: a bounded retry over
transient I/O with the `loader-fetch` fault site (utils/faults.py) once
an attempt, as the JAX loader's synchronous path fetches
(HYDRAGNN_ASYNC_LOADER=0).

Packing across processes (`pack_rank`, `pack_nproc`): every rank plans
the same global order and takes its bin of each global step of
`pack_nproc` bins (`graphs.packing.plan_steps`); a padding bin of the
tail is an all-padding batch.

Stacked shards (`num_shards` M > 1, fixed-shape only; the pipeline's
microbatches, JAX loader.py:318-339): each batch of `batch_size` graphs
is split into M shards of `batch_size / M` graphs in order, each collated
to the one per-shard shape (room for `batch_size / M` of the largest
graphs, `batch_size / M + 1` graph slots), an empty shard of the tail an
all-padding batch, and stacked into a GraphBatch of [M, ...] tensors
(`stack_batches`; `unstack_batch` is its inverse). Background collation
and the batch cache (A10) are not ported.

`_postprocess_shard(batch, shard_sel)` is a subclass's hook on each
shard's batch after its collate and before stacking, on the packed and
the fixed routes, where the JAX loader calls it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import logging
import math
import time
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..graphs.batch import (BucketSpec, GraphBatch, GraphSample, collate,
                            neighbor_budget_for_dataset, padding_batch,
                            with_neighbor_format)
from ..graphs.packing import (choose_budget, pack_order, plan_padding_stats,
                              plan_steps, sample_sizes)
from ..telemetry.registry import get_registry
from ..utils.envflags import resolve_loader_retries
from ..utils.faults import fault_point


def fetch_samples(dataset, indices) -> list:
    """`dataset[i]` for each index, with a bounded retry over transient
    I/O (counterpart: hydragnn_tpu/datasets/async_loader.py::
    fetch_samples): an OSError is retried up to
    HYDRAGNN_LOADER_RETRIES tries in all, waiting
    HYDRAGNN_LOADER_RETRY_BACKOFF_S doubled a retry (at most 1 s), and
    the last one raises. The `loader-fetch` fault site fires once an
    attempt, so one listed index is recovered and `attempts` consecutive
    ones surface. Each retry counts in `loader_retries_total`."""
    attempts, backoff = resolve_loader_retries()
    out = []
    for i in indices:
        for attempt in range(attempts):
            try:
                fault_point("loader-fetch")
                out.append(dataset[i])
                break
            except OSError as exc:
                if attempt + 1 >= attempts:
                    raise
                get_registry().counter_inc(
                    "loader_retries_total",
                    help="transient dataset-fetch retries")
                delay = min(backoff * (2 ** attempt), 1.0)
                logging.getLogger("hydragnn_tpu_torch").warning(
                    "transient fetch failure for dataset[%s] (%s: %s); "
                    "retry %d/%d after %.3fs", i,
                    type(exc).__name__, exc, attempt + 1, attempts - 1,
                    delay)
                time.sleep(delay)
    return out


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
                 neighbor_k: Optional[int] = None, packing: bool = False,
                 pack_budget=None, pack_lookahead: Optional[int] = None,
                 pack_rank: int = 0, pack_nproc: int = 1,
                 batch_transform=None, num_shards: int = 1):
        num_shards = max(int(num_shards), 1)
        if num_shards > 1 and batch_size % num_shards:
            raise ValueError(
                f"batch_size {batch_size} must divide evenly over "
                f"{num_shards} shards")
        if num_shards > 1 and packing:
            raise ValueError("stacked shards are fixed-shape: packing "
                             "takes num_shards=1")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.graphs_per_shard = max(batch_size // num_shards, 1)
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.drop_last = shuffle if drop_last is None else drop_last
        self.packing = bool(packing)
        self.pack_rank, self.pack_nproc = int(pack_rank), int(pack_nproc)
        self.pack_budget = None
        self._sizes = None        # (nodes[], edges[]), scanned once
        self._plan_cache = {}     # epoch -> (bins, selections)
        if self.packing:
            nodes, edges = self._sample_sizes()
            if pack_budget is None:
                pack_budget = choose_budget(nodes, edges, batch_size,
                                            lookahead=pack_lookahead)
            elif pack_lookahead:
                pack_budget = dataclasses.replace(
                    pack_budget, lookahead=int(pack_lookahead))
            self.pack_budget = pack_budget
            n_node, n_edge = pack_budget.n_node, pack_budget.n_edge
        elif n_node is None or n_edge is None:
            n_node, n_edge = padded_budgets(dataset, self.graphs_per_shard)
        self.n_node = n_node
        self.n_edge = n_edge
        self.n_graph = (pack_budget.n_graph if self.packing
                        else self.graphs_per_shard + 1)
        self.batch_transform = batch_transform
        self._transform_arity = None
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
        if self.packing:
            return len(self._plan()[1])
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

    def _sample_sizes(self):
        """(nodes[], edges[]) per dataset index, scanned once."""
        if self._sizes is None:
            self._sizes = sample_sizes(self.dataset)
        return self._sizes

    def _plan(self):
        """The epoch's pack plan, (global bins, this rank's selections),
        built once an epoch (only the current epoch's is kept): the plan
        of the global order, sliced per (pack_rank, pack_nproc); each
        selection is a 1-tuple of one bin."""
        key = self.epoch if self.shuffle else -1
        hit = self._plan_cache.get(key)
        if hit is None:
            nodes, edges = self._sample_sizes()
            bins = pack_order(self._order(), nodes, edges, self.pack_budget)
            hit = (bins, plan_steps(bins, 1, self.pack_nproc,
                                    self.pack_rank,
                                    drop_last=self.drop_last))
            self._plan_cache = {key: hit}
        return hit

    def global_plan_fingerprint(self) -> str:
        """sha256 (first 16 hex digits) of the current epoch's global pack
        plan: its bins before the per-rank slicing, the budget's shape and
        the global shard count (`pack_nproc`, one shard a rank), as the
        JAX package's run_training logs it; equal on every rank.
        Packing-mode loaders only."""
        if not self.packing:
            raise ValueError(
                "global_plan_fingerprint is defined for packing-mode "
                "loaders only")
        bins, _ = self._plan()
        b = self.pack_budget
        payload = repr((tuple(tuple(int(i) for i in bn) for bn in bins),
                        (b.n_node, b.n_edge, b.n_graph), self.pack_nproc))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def padding_stats(self):
        """The fraction of the current epoch's node and edge slots that
        are padding (`graphs.packing.plan_padding_stats`), packed or
        fixed, with `packing` naming the mode."""
        nodes, edges = self._sample_sizes()
        sels = self._selections()
        if not self.packing:
            g = self.graphs_per_shard
            sels = [tuple(tuple(sel[sh * g:(sh + 1) * g])
                          for sh in range(self.num_shards)) for sel in sels]
        stats = plan_padding_stats(sels, nodes, edges, self.n_node,
                                   self.n_edge)
        stats["packing"] = "packed" if self.packing else "fixed"
        return stats

    def _selections(self) -> List[Tuple[int, ...]]:
        """The epoch's batch index tuples, in yield order; packed, each is
        a tuple of one bin's tuple."""
        if self.packing:
            return self._plan()[1]
        order = self._order()
        return [tuple(int(i) for i in
                      order[ib * self.batch_size:(ib + 1) * self.batch_size])
                for ib in range(len(self))]

    def _build_batch(self, sel: Tuple[int, ...]) -> GraphBatch:
        if self.packing:
            (sel,) = sel
        samples = fetch_samples(self.dataset, sel)
        if self.num_shards == 1:
            return self._postprocess_shard(self._collate_shard(samples),
                                           tuple(sel))
        g = self.graphs_per_shard
        return stack_batches([
            self._postprocess_shard(
                self._collate_shard(samples[sh * g:(sh + 1) * g]),
                tuple(sel[sh * g:(sh + 1) * g]))
            for sh in range(self.num_shards)])

    def _postprocess_shard(self, batch: GraphBatch,
                           shard_sel: Tuple[int, ...]) -> GraphBatch:
        """Subclass hook (JAX loader.py:307-333): a shard's batch after its
        collate, before any stacking, with the dataset indices it holds.
        The mixture loader (parallel/multidataset.GfmMixtureLoader) sets
        `dataset_id` here."""
        return batch

    def _collate_shard(self, samples) -> GraphBatch:
        b = (collate(samples, n_node=self.n_node, n_edge=self.n_edge,
                     n_graph=self.n_graph) if samples
             else padding_batch(self.dataset[0], self.n_node, self.n_edge,
                                self.n_graph))
        if self.batch_transform is not None:
            b = self._apply_transform(b, samples)
        # after the transform, which may rewire edges: the tables describe
        # the edges the model sees
        if self.neighbor_k is not None:
            b = with_neighbor_format(b, k=self.neighbor_k)
        return b

    def _apply_transform(self, b: GraphBatch, samples) -> GraphBatch:
        if self._transform_arity is None:
            try:
                params = [
                    p for p in inspect.signature(
                        self.batch_transform).parameters.values()
                    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
                self._transform_arity = min(len(params), 2)
            except (TypeError, ValueError):
                self._transform_arity = 1
        if self._transform_arity >= 2:
            return self.batch_transform(b, samples)
        return self.batch_transform(b)

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


# fields an absent shard may carry as zeros: no-ops in the edge geometry
_ZERO_FILL_OK = ("edge_shifts", "cell")


def stack_batches(shards: List[GraphBatch]) -> GraphBatch:
    """Shard batches of one shape stacked into [M, ...] tensors
    (counterpart: hydragnn_tpu/datasets/loader.py `_stack_batches`). A
    field present on some shards only is zero-filled where it is a
    geometry field (edge_shifts, cell) and raises otherwise."""
    import torch

    def stk(name):
        vals = [getattr(s, name) for s in shards]
        present = [v for v in vals if v is not None]
        if not present:
            return None
        if len(present) < len(vals):
            if name not in _ZERO_FILL_OK:
                raise ValueError(
                    f"member datasets disagree on field '{name}': present "
                    f"on {len(present)}/{len(vals)} shards — all member "
                    "datasets must share one label/feature schema")
            vals = [torch.zeros_like(present[0]) if v is None else v
                    for v in vals]
        return torch.stack(vals, dim=0)
    return GraphBatch(**{f.name: stk(f.name)
                         for f in dataclasses.fields(GraphBatch)})


def unstack_batch(stacked: GraphBatch) -> List[GraphBatch]:
    """The M shard batches (views) of a stacked [M, ...] batch; an
    unstacked batch is one shard."""
    if stacked.x.dim() == 2:
        return [stacked]
    fields = [f.name for f in dataclasses.fields(GraphBatch)]
    return [GraphBatch(**{n: (None if getattr(stacked, n) is None
                              else getattr(stacked, n)[m]) for n in fields})
            for m in range(stacked.x.shape[0])]
