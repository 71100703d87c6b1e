"""Multi-dataset ("GFM") mixture training (counterpart:
hydragnn_tpu/parallel/multidataset.py). Everything here is host numpy,
bitwise the JAX package's.

Two loaders:

* `GfmMixtureLoader`: one deterministic global pack plan over the union
  of the member datasets. An epoch's interleaved order (`mixture_order`)
  is a pure function of (seed, epoch) and the mixture spec, computed
  before any per-rank slicing; it is packed against one budget over the
  union's sizes (graphs/packing.py) and sliced per (pack_rank,
  pack_nproc) as the packing `GraphDataLoader` slices its plan. Every
  batch has one padded shape, so a mixture trains through one captured
  step, and a member added under a pinned budget adds none. Each batch
  carries `dataset_id` (the member of each graph slot, -1 on padding),
  by which train/loss.head_loss_mask narrows head i to member i.
* `MultiDatasetLoader`: stacked [D, ...] batches whose shard d cycles
  its own shuffled stream of the member it is assigned
  (`assign_shards_to_datasets`, proportional to the members' sizes);
  the streams are independent. `shard=r` yields only shard r's stream,
  for rank r of a D-rank data-parallel run: bitwise
  `unstack_batch(stacked)[r]`.

Members come as a Mapping (iterated sorted by name, so the budget, the
plan and the head-dataset binding follow the mixture's content, never
its construction order) or a sequence (positional, named `dataset<i>`).

Background collation and the batch cache (ROADMAP A10) are not ported:
`async_workers` / `cache_mb` None read nothing (the port does not read
HYDRAGNN_ASYNC_LOADER; JAX's asynchronous stream is bitwise its
synchronous one) and a value above 0 raises naming A10.
"""
from __future__ import annotations

import hashlib
import math
from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..datasets.loader import (GraphDataLoader, dataset_invariants,
                               stack_batches)
from ..graphs.batch import BucketSpec, GraphBatch, GraphSample
from ..graphs.packing import choose_budget, sample_sizes


def assign_shards_to_datasets(sizes: Sequence[int],
                              num_shards: int) -> List[int]:
    """The member of each device shard: proportional to the members'
    sizes, largest remainder first, at least one shard a member."""
    n = len(sizes)
    if num_shards < n:
        raise ValueError(
            f"need at least one device shard per dataset ({n}), "
            f"got {num_shards}")
    total = float(sum(sizes))
    raw = [s / total * num_shards for s in sizes]
    counts = [max(1, int(math.floor(r))) for r in raw]
    while sum(counts) > num_shards:
        counts[int(np.argmax(counts))] -= 1
    rema = [r - c for r, c in zip(raw, counts)]
    while sum(counts) < num_shards:
        i = int(np.argmax(rema))
        counts[i] += 1
        rema[i] = -1
    out = []
    for ds_idx, c in enumerate(counts):
        out += [ds_idx] * c
    return out


def merge_pna_deg(histograms: Sequence[Sequence[int]]) -> List[int]:
    """The members' PNA degree histograms summed into one, each padded
    with zeros to the longest (exact counts: the sum loses nothing)."""
    maxlen = max(len(h) for h in histograms)
    out = np.zeros(maxlen, np.int64)
    for h in histograms:
        out[:len(h)] += np.asarray(h, np.int64)
    return out.tolist()


def _normalize_members(datasets):
    """(names, members) in the pinned order: a Mapping sorted by name, a
    sequence by position (named `dataset<i>`)."""
    if isinstance(datasets, Mapping):
        names = tuple(sorted(str(k) for k in datasets.keys()))
        members = [datasets[n] for n in names]
    else:
        members = list(datasets)
        names = tuple(f"dataset{i}" for i in range(len(members)))
    if not members:
        raise ValueError("at least one member dataset is required")
    for name, m in zip(names, members):
        if len(m) == 0:
            raise ValueError(f"member dataset '{name}' is empty")
    return names, members


def validate_member_heads(cfg, names: Sequence[str], members,
                          per_dataset_heads: bool = False) -> None:
    """Raise ValueError, naming the dataset and the head, where the
    mixture and the model's heads disagree: `task_weights` of another
    length than the heads; with `per_dataset_heads` (the GFM mixture)
    another head count than members (head i is member i, in the pinned
    order); a member whose first sample's packed labels are too narrow
    for a head that reads it (every head for `MultiDatasetLoader`, its
    own for the mixture)."""
    heads = cfg.heads
    if len(cfg.task_weights) != len(heads):
        raise ValueError(
            f"config declares {len(heads)} heads but "
            f"{len(cfg.task_weights)} task_weights — one loss weight per "
            "head is required")
    if per_dataset_heads and len(heads) != len(names):
        raise ValueError(
            f"GFM mixture has {len(names)} member datasets "
            f"({', '.join(names)}) but the model defines {len(heads)} "
            "heads — the head-masked multi-task step binds head i to "
            "member dataset i (sorted member order), so the counts must "
            "match")

    def _check(ds_idx, ih):
        head = heads[ih]
        s = members[ds_idx][0]
        y = s.y_graph if head.head_type == "graph" else s.y_node
        width = 0 if y is None else (
            y.shape[0] if head.head_type == "graph" else y.shape[1])
        end = head.offset + head.output_dim
        if width < end:
            label = head.name or f"head_{ih}"
            raise ValueError(
                f"dataset '{names[ds_idx]}' provides "
                f"{width} packed {head.head_type}-label columns but "
                f"{head.head_type} head '{label}' (index {ih}) reads "
                f"columns [{head.offset}:{end}) — widen the member's "
                "labels to the union layout (docs/gfm.md) or fix the "
                "head's output_dim/offset")

    for d in range(len(names)):
        if per_dataset_heads:
            _check(d, d)
        else:
            for ih in range(len(heads)):
                _check(d, ih)


def mixture_quotas(sizes: Sequence[int], weights: Sequence[float],
                   total: Optional[int] = None) -> List[int]:
    """Each member's draws in an epoch: `total` (default the members'
    summed size) apportioned by weight, largest remainder first, with at
    least one draw a member where `total` allows."""
    sizes = [int(s) for s in sizes]
    w = np.asarray([float(x) for x in weights], np.float64)
    if np.any(w <= 0) or not np.all(np.isfinite(w)):
        raise ValueError(f"mixture weights must be positive finite, got "
                         f"{list(weights)}")
    if total is None:
        total = sum(sizes)
    total = int(total)
    share = w / w.sum() * total
    base = np.floor(share).astype(np.int64)
    order = np.argsort(-(share - base), kind="stable")
    for i in order[:total - int(base.sum())]:
        base[i] += 1
    if total >= len(sizes):
        while np.any(base == 0):
            base[int(np.argmin(base))] += 1
            base[int(np.argmax(base))] -= 1
    return [int(b) for b in base]


def mixture_order(sizes: Sequence[int], quotas: Sequence[int],
                  seed: int, epoch: int) -> np.ndarray:
    """The epoch's global order over the concatenated members, a pure
    function of (seed, epoch) and the spec (no rank or world input).
    Member d draws `quotas[d]` samples from shuffled passes, pass c the
    permutation of `np.random.RandomState([seed, epoch, d, c])`; draw j
    of member d sorts by ((j + 1) / quota_d, d), a weighted round-robin
    that spreads each member over the epoch."""
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    all_idx, all_keys, all_ds = [], [], []
    base_seed = int(seed) & 0x7FFFFFFF
    for d, (n, q) in enumerate(zip(sizes, quotas)):
        if q <= 0:
            continue
        cycles = -(-q // n)
        perms = [np.random.RandomState(
            [base_seed, int(epoch), d, c]).permutation(n)
            for c in range(cycles)]
        idx = np.concatenate(perms)[:q] + offsets[d]
        all_idx.append(idx.astype(np.int64))
        all_keys.append((np.arange(q, dtype=np.float64) + 1.0) / q)
        all_ds.append(np.full(q, d, np.int64))
    idx = np.concatenate(all_idx)
    keys = np.concatenate(all_keys)
    ds = np.concatenate(all_ds)
    return idx[np.lexsort((ds, keys))]


def _check_unported_loader_knobs(async_workers, cache_mb) -> None:
    """JAX's background collation and batch cache (ROADMAP A10)."""
    for what, value in (("async_workers", async_workers),
                        ("cache_mb", cache_mb)):
        if value is not None and int(value) > 0:
            raise NotImplementedError(
                f"{what}={value} (the loader's background collation and "
                "batch cache) is not ported to hydragnn_tpu_torch yet "
                "(ROADMAP A10)")


class GfmMixtureLoader(GraphDataLoader):
    """The packing `GraphDataLoader` over the concatenated members whose
    epoch order is the global mixture interleave (`mixture_order`); the
    plan, its per-(pack_rank, pack_nproc) slice and the padding
    statistics are the base loader's. Every batch carries `dataset_id`.

    `weights` maps member name to sampling weight (a member left out
    weighs 1.0, an unknown name raises); without them an epoch draws
    every sample once. `weight_schedule` is one such mapping an epoch,
    epoch e drawing under entry min(e, last); a constant schedule is
    bitwise the unscheduled plan, and the fingerprint folds a schedule.
    `pack_budget` pins the union budget from outside (a sub-mixture
    trained under the full mixture's shapes). `cfg` checks the heads
    against the members (`validate_member_heads`, one head a member).
    Stacked shards take fixed shapes only (the port's loader refuses
    `num_shards` > 1 with packing): rank r of W takes row r of a W-shard
    plan through pack_rank=r, pack_nproc=W."""

    def __init__(self, datasets, batch_size: int, *, cfg=None,
                 weights: Optional[Mapping[str, float]] = None,
                 weight_schedule: Optional[
                     Sequence[Mapping[str, float]]] = None,
                 seed: int = 0, num_shards: int = 1,
                 epoch_quota: Optional[int] = None,
                 pack_budget=None, pack_lookahead: Optional[int] = None,
                 pack_rank: int = 0, pack_nproc: int = 1,
                 async_workers: Optional[int] = None,
                 cache_mb: Optional[int] = None):
        _check_unported_loader_knobs(async_workers, cache_mb)
        names, members = _normalize_members(datasets)
        if cfg is not None:
            validate_member_heads(cfg, names, members,
                                  per_dataset_heads=True)
        self.member_names = names
        self.member_sizes = [len(m) for m in members]

        def _resolve_weights(spec):
            if spec:
                unknown = sorted(set(spec) - set(names))
                if unknown:
                    raise ValueError(
                        f"mixture weights name unknown dataset(s) "
                        f"{unknown}; members are {sorted(names)}")
                return tuple(float(spec.get(n, 1.0)) for n in names)
            # every sample once: weights proportional to the sizes
            return tuple(float(s) for s in self.member_sizes)

        if weight_schedule is not None and weights is not None:
            raise ValueError(
                "pass weights OR weight_schedule, not both — a schedule "
                "IS the per-epoch weights")
        if weight_schedule is not None and not len(weight_schedule):
            raise ValueError("weight_schedule must have >= 1 entry")
        self.member_weights = _resolve_weights(
            weight_schedule[0] if weight_schedule is not None
            else weights)
        # every entry is checked now, not at its epoch
        self._weight_schedule = (
            None if weight_schedule is None
            else tuple(_resolve_weights(s) for s in weight_schedule))
        self._epoch_quota = epoch_quota
        self._quotas = mixture_quotas(self.member_sizes,
                                      self.member_weights, epoch_quota)
        self._ds_of = np.repeat(
            np.arange(len(members), dtype=np.int32), self.member_sizes)
        concat: List[GraphSample] = []
        for m in members:
            concat.extend(m)
        super().__init__(
            concat, batch_size, shuffle=True, seed=seed,
            num_shards=num_shards, drop_last=True, packing=True,
            pack_budget=pack_budget, pack_lookahead=pack_lookahead,
            pack_rank=pack_rank, pack_nproc=pack_nproc)

    def _epoch_weights(self, epoch: int) -> Tuple[float, ...]:
        """The epoch's weights: the schedule's entry min(epoch, last), or
        the constant weights."""
        if self._weight_schedule is None:
            return self.member_weights
        return self._weight_schedule[
            min(int(epoch), len(self._weight_schedule) - 1)]

    def _epoch_quotas(self, epoch: int) -> List[int]:
        if self._weight_schedule is None:
            return self._quotas
        return mixture_quotas(self.member_sizes,
                              self._epoch_weights(epoch),
                              self._epoch_quota)

    def _order(self) -> np.ndarray:
        # the global interleave; the base loader packs and slices it
        return mixture_order(self.member_sizes,
                             self._epoch_quotas(self.epoch),
                             self.seed, self.epoch)

    def _postprocess_shard(self, batch: GraphBatch,
                           shard_sel) -> GraphBatch:
        import torch
        ids = np.full(self.n_graph, -1, np.int32)
        if len(shard_sel):
            ids[:len(shard_sel)] = self._ds_of[list(shard_sel)]
        return batch.replace(dataset_id=torch.from_numpy(ids))

    def mixture_fractions(self) -> "dict[str, float]":
        """Member name -> its share of the current epoch's global plan
        (from the quotas, not measured); under a schedule, the epoch's
        entry's."""
        quotas = self._epoch_quotas(self.epoch)
        total = max(sum(quotas), 1)
        return {n: q / total for n, q in zip(self.member_names, quotas)}

    def global_plan_fingerprint(self) -> str:
        """The packing fingerprint with the mixture spec (member names,
        weights, quotas) folded in, and the schedule only when one is
        set: the same 16 hex digits as the JAX package's for the same
        inputs."""
        base = super().global_plan_fingerprint()
        payload = repr((base, self.member_names, self.member_weights,
                        tuple(self._quotas)))
        if self._weight_schedule is not None:
            payload = repr((payload, self._weight_schedule))
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


class MultiDatasetLoader:
    """Stacked [num_shards, ...] batches where shard d cycles a shuffled
    stream of its assigned member (loader seed `seed * 1000 + d`), every
    shard one padded shape: with `packing`, one budget over the union's
    sizes; else room for `batch_size / num_shards` of the largest graphs
    of any member (`bucket`, default BucketSpec(multiple=64)). An epoch
    is the longest stream's length; shorter streams start a fresh pass
    (their own next epoch) when they run out. `shard=r` yields shard r's
    batches alone, unstacked (rank r of a data-parallel run), bitwise
    the stacked batch's row r. `cfg` checks every member against every
    head (`validate_member_heads`)."""

    def __init__(self, datasets, batch_size: int, num_shards: int,
                 seed: int = 0, bucket: Optional[BucketSpec] = None,
                 packing: bool = False,
                 pack_lookahead: Optional[int] = None, cfg=None,
                 shard: Optional[int] = None):
        if batch_size % num_shards != 0:
            raise ValueError(
                f"batch_size {batch_size} must divide evenly over "
                f"{num_shards} shards")
        if shard is not None and not 0 <= int(shard) < num_shards:
            raise ValueError(f"shard {shard} is not one of the "
                             f"{num_shards} shards")
        names, members = _normalize_members(datasets)
        if cfg is not None:
            validate_member_heads(cfg, names, members,
                                  per_dataset_heads=False)
        self.member_names = names
        self.gps = batch_size // num_shards
        self.assignment = assign_shards_to_datasets(
            [len(d) for d in members], num_shards)
        self.packing = bool(packing)
        self.shard = None if shard is None else int(shard)
        pack_budget = None
        if self.packing:
            sizes = [sample_sizes(d) for d in members]
            nodes = np.concatenate([s[0] for s in sizes])
            edges = np.concatenate([s[1] for s in sizes])
            pack_budget = choose_budget(nodes, edges, self.gps,
                                        lookahead=pack_lookahead)
            n_node, n_edge = pack_budget.n_node, pack_budget.n_edge
        else:
            bucket = bucket or BucketSpec(multiple=64)
            invs = [dataset_invariants(d) for d in members]
            max_n = max(i.max_nodes for i in invs)
            max_e = max(i.max_edges for i in invs)
            n_node = bucket.bucket(max_n * self.gps + 1)
            n_edge = bucket.bucket(max_e * self.gps + 1)
        self.loaders = [
            GraphDataLoader(
                members[ds_idx], self.gps, shuffle=True,
                seed=seed * 1000 + sh, drop_last=True,
                n_node=None if self.packing else n_node,
                n_edge=None if self.packing else n_edge,
                packing=self.packing, pack_budget=pack_budget)
            for sh, ds_idx in enumerate(self.assignment)]
        self.n_node, self.n_edge = n_node, n_edge
        self.n_graph = (pack_budget.n_graph if self.packing
                        else self.gps + 1)
        self.graphs_per_shard = self.gps

    def set_epoch(self, epoch: int):
        for ld in self.loaders:
            ld.set_epoch(epoch)

    def __len__(self):
        # an epoch cycles the longest shard stream once
        return max(len(ld) for ld in self.loaders)

    def padding_stats(self):
        """Slot-weighted padding over the shard streams' current plans
        (GraphDataLoader.padding_stats's fields)."""
        stats = [s for s in (ld.padding_stats() for ld in self.loaders)
                 if s is not None]
        if not stats:
            return None
        tot = max(sum(s["shards"] for s in stats), 1)
        return {
            "padding_frac_nodes": sum(
                s["padding_frac_nodes"] * s["shards"] for s in stats) / tot,
            "padding_frac_edges": sum(
                s["padding_frac_edges"] * s["shards"] for s in stats) / tot,
            "shards": tot,
            "packing": "packed" if self.packing else "fixed",
        }

    def __iter__(self):
        shards = (range(len(self.loaders)) if self.shard is None
                  else (self.shard,))
        n = len(self)
        iters = {i: iter(self.loaders[i]) for i in shards}
        for _ in range(n):
            out = []
            for i in shards:
                try:
                    out.append(next(iters[i]))
                except StopIteration:
                    # a shorter stream starts a fresh shuffled pass
                    self.loaders[i].set_epoch(self.loaders[i].epoch + 1)
                    iters[i] = iter(self.loaders[i])
                    out.append(next(iters[i]))
            yield out[0] if self.shard is not None else stack_batches(out)
