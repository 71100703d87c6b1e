"""Budget sizing from a dataset's size histogram (counterpart:
hydragnn_tpu/graphs/packing.py — `PackBudget`, `sample_sizes` and
`choose_budget`; the pack planner itself comes with the training slice).
The serving engine sizes its bucket ladder with `choose_budget`."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

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
