"""Budget-packed graph batching (counterpart:
hydragnn_tpu/graphs/packing.py): a variable number of graphs packed into
one fixed (n_node, n_edge, n_graph) budget sized for the mean batch, so
every batch of a run has one shape (one CUDA graph per step) and far less
padding than room for `batch_size` of the largest graphs.

* `choose_budget` sizes the budget from the dataset's size histogram (the
  serving engine sizes its bucket ladder with it too);
* `pack_order` packs an epoch's order into bins, first-fit-decreasing
  within a bounded lookahead window, deterministically;
* `plan_steps` groups the bins into steps; `plan_padding_stats` measures
  a plan's padding.

All host numpy, bitwise the JAX package's plans."""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .batch import _round_up

DEFAULT_LOOKAHEAD = 128
# sanity cap on real graph slots per bin
MAX_GRAPH_SLOTS = 4096


@dataclasses.dataclass(frozen=True)
class PackBudget:
    """Per-shard padded budget with collate's conventions: one padding
    node and one padding graph slot are always reserved."""

    n_node: int
    n_edge: int
    n_graph: int
    lookahead: int = DEFAULT_LOOKAHEAD

    @property
    def cap_nodes(self) -> int:
        return self.n_node - 1

    @property
    def cap_edges(self) -> int:
        return self.n_edge

    @property
    def cap_graphs(self) -> int:
        return self.n_graph - 1


def sample_sizes(samples: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """One pass over the dataset -> (nodes[i], edges[i]) int64 arrays."""
    nodes = np.empty(len(samples), np.int64)
    edges = np.empty(len(samples), np.int64)
    for i, s in enumerate(samples):
        nodes[i] = s.num_nodes
        edges[i] = s.num_edges
    return nodes, edges


def choose_budget(nodes: np.ndarray, edges: np.ndarray,
                  graphs_per_batch: int, multiple: int = 64,
                  lookahead: Optional[int] = None) -> PackBudget:
    """Node/edge capacities for `graphs_per_batch` average graphs (never
    below one max-size graph), rounded up to `multiple`; graph slots so a
    bin of the smallest graphs never closes on the graph axis first."""
    nodes = np.asarray(nodes)
    edges = np.asarray(edges)
    if nodes.size == 0:
        raise ValueError("choose_budget: empty dataset")
    g = max(int(graphs_per_batch), 1)
    mean_n = float(nodes.mean())
    mean_e = float(edges.mean())
    max_n = int(nodes.max())
    max_e = int(edges.max())
    min_n = max(int(nodes.min()), 1)
    cap_n = max(int(math.ceil(mean_n * g)), max_n)
    cap_e = max(int(math.ceil(mean_e * g)), max_e, 1)
    n_node = _round_up(cap_n + 1, multiple)
    n_edge = _round_up(cap_e, multiple)
    slots = min(int(math.ceil((n_node - 1) / min_n)), MAX_GRAPH_SLOTS)
    return PackBudget(n_node=n_node, n_edge=n_edge,
                      n_graph=max(slots, g) + 1,
                      lookahead=int(lookahead or DEFAULT_LOOKAHEAD))


def check_fits(nodes: np.ndarray, edges: np.ndarray, budget: PackBudget,
               indices=None) -> None:
    """Raise before any packing if a single graph overflows the budget.
    `indices` maps positions in `nodes`/`edges` to dataset indices, so the
    message names the sample, not its place in a shuffled order."""
    over_n = np.nonzero(np.asarray(nodes) > budget.cap_nodes)[0]
    over_e = np.nonzero(np.asarray(edges) > budget.cap_edges)[0]
    if over_n.size or over_e.size:
        i = int(over_n[0] if over_n.size else over_e[0])
        ds_i = int(np.asarray(indices)[i]) if indices is not None else i
        raise ValueError(
            f"budget-packed batching: sample {ds_i} "
            f"({int(np.asarray(nodes)[i])} nodes, "
            f"{int(np.asarray(edges)[i])} edges) does not fit the pack "
            f"budget (capacity {budget.cap_nodes} nodes / "
            f"{budget.cap_edges} edges per bin, from n_node="
            f"{budget.n_node}, n_edge={budget.n_edge}) — raise the "
            "budget (larger batch_size or explicit pack budget) or "
            "filter oversized graphs from the dataset")


def pack_order(order: Sequence[int], nodes: np.ndarray, edges: np.ndarray,
               budget: PackBudget) -> List[Tuple[int, ...]]:
    """Pack the epoch order into bins of dataset indices: the next
    `budget.lookahead` samples of the stream are kept sorted by
    (-nodes, stream position); the first of them that fits the open bin
    goes in and the window refills; the bin closes when none fits. Every
    sample lands in exactly one bin."""
    order = [int(i) for i in order]
    nodes = np.asarray(nodes)
    edges = np.asarray(edges)
    check_fits(nodes[order] if order else nodes[:0],
               edges[order] if order else edges[:0], budget,
               indices=order)
    keys: List[Tuple[int, int]] = []
    vals: List[int] = []          # dataset index, parallel to keys
    stream = iter(enumerate(order))
    exhausted = False

    def refill():
        nonlocal exhausted
        while not exhausted and len(keys) < budget.lookahead:
            try:
                pos, idx = next(stream)
            except StopIteration:
                exhausted = True
                return
            k = (-int(nodes[idx]), pos)
            at = bisect.bisect_left(keys, k)
            keys.insert(at, k)
            vals.insert(at, idx)

    refill()
    bins: List[Tuple[int, ...]] = []
    cur: List[int] = []
    rem_n, rem_e, rem_g = (budget.cap_nodes, budget.cap_edges,
                           budget.cap_graphs)
    while keys:
        placed = False
        if rem_g > 0:
            for i in range(len(keys)):
                idx = vals[i]
                if nodes[idx] <= rem_n and edges[idx] <= rem_e:
                    keys.pop(i)
                    vals.pop(i)
                    cur.append(idx)
                    rem_n -= int(nodes[idx])
                    rem_e -= int(edges[idx])
                    rem_g -= 1
                    refill()
                    placed = True
                    break
        if not placed:
            bins.append(tuple(cur))
            cur = []
            rem_n, rem_e, rem_g = (budget.cap_nodes, budget.cap_edges,
                                   budget.cap_graphs)
    if cur:
        bins.append(tuple(cur))
    return bins


def plan_steps(bins: Sequence[Tuple[int, ...]], num_shards: int,
               nproc: int = 1, rank: int = 0, drop_last: bool = True
               ) -> List[Tuple[Tuple[int, ...], ...]]:
    """Group bins into this rank's per-step selections: global step g
    takes `num_shards * nproc` consecutive bins, rank r the `num_shards`
    of them from `r * num_shards`. The tail is dropped (`drop_last`) or
    padded with empty bins, never down to zero steps while bins exist."""
    bins = list(bins)
    per_step = max(num_shards, 1) * max(nproc, 1)
    nsteps = len(bins) // per_step
    rem = len(bins) - nsteps * per_step
    if rem and (not drop_last or nsteps == 0):
        bins = bins + [()] * (per_step - rem)
        nsteps += 1
    sels = []
    for g in range(nsteps):
        base = g * per_step + rank * num_shards
        sels.append(tuple(bins[base:base + num_shards]))
    return sels


def plan_padding_stats(selections: Sequence, nodes: np.ndarray,
                       edges: np.ndarray, n_node: int, n_edge: int
                       ) -> Dict[str, float]:
    """The fraction of a plan's node and edge slots that are padding, over
    the epoch, with the real graphs and the shards counted. Takes packed
    (tuples of per-shard tuples) and fixed (flat tuples) selections."""
    nodes = np.asarray(nodes)
    edges = np.asarray(edges)
    shards = 0
    real_n = 0
    real_e = 0
    graphs = 0
    for sel in selections:
        parts = sel if sel and isinstance(sel[0], tuple) else (sel,)
        for part in parts:
            shards += 1
            if part:
                idx = np.asarray(part, np.int64)
                real_n += int(nodes[idx].sum())
                real_e += int(edges[idx].sum())
                graphs += len(part)
    node_slots = shards * n_node
    edge_slots = shards * n_edge
    return {
        "padding_frac_nodes": (1.0 - real_n / node_slots) if node_slots
        else 0.0,
        "padding_frac_edges": (1.0 - real_e / edge_slots) if edge_slots
        else 0.0,
        "real_graphs": graphs,
        "shards": shards,
    }
