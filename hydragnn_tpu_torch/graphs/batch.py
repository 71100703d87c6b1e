"""Static-shape padded graph batching (counterpart:
hydragnn_tpu/graphs/batch.py).

The padding convention is the JAX package's:

* the **last graph slot** is the padding graph,
* the **last node slot** is the padding node,
* padding edges are self-loops on the padding node with mask False,
* boolean masks mark real vs padding entries.

Batches are assembled in numpy on the host (bitwise what the JAX package
assembles) and handed out as a `GraphBatch` of CPU tensors that share the
numpy buffers; `GraphBatch.to(device)` moves them to the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class GraphBatch:
    """A fixed-shape batch of graphs. N = padded node count, E = padded
    edge count, G = padded graph count."""

    x: torch.Tensor            # [N, F] node input features
    pos: torch.Tensor          # [N, 3]
    senders: torch.Tensor      # [E] int32
    receivers: torch.Tensor    # [E] int32
    node_graph: torch.Tensor   # [N] int32, graph id of each node
    node_mask: torch.Tensor    # [N] bool
    edge_mask: torch.Tensor    # [E] bool
    graph_mask: torch.Tensor   # [G] bool
    y_graph: Optional[torch.Tensor] = None     # [G, Dg]
    y_node: Optional[torch.Tensor] = None      # [N, Dn]
    edge_attr: Optional[torch.Tensor] = None   # [E, Fe]
    edge_shifts: Optional[torch.Tensor] = None  # [E, 3]
    cell: Optional[torch.Tensor] = None        # [G, 3, 3]
    energy: Optional[torch.Tensor] = None      # [G, 1]
    forces: Optional[torch.Tensor] = None      # [N, 3]
    # DimeNet's triplets (graphs/triplets.py): indices into the edges
    idx_kj: Optional[torch.Tensor] = None      # [T] int32 edge of (k->j)
    idx_ji: Optional[torch.Tensor] = None      # [T] int32 edge of (j->i)
    triplet_mask: Optional[torch.Tensor] = None  # [T] bool
    # dense neighbor layout (with_neighbor_format)
    nbr: Optional[torch.Tensor] = None         # [N, K] int32 sender of slot k
    nbr_edge: Optional[torch.Tensor] = None    # [N, K] int32 edge id of slot k
    nbr_mask: Optional[torch.Tensor] = None    # [N, K] bool
    # multi-dataset (GFM) mixtures (parallel/multidataset.py): the member
    # dataset of each graph slot, -1 on padding; train/loss.head_loss_mask
    # narrows head i's loss to member i's graphs. `collate` leaves it None.
    dataset_id: Optional[torch.Tensor] = None  # [G] int32
    # sampled training on one giant graph (preprocess/sampling.py): the
    # node slots are one k-hop computation graph [seeds | hop1 | ... |
    # padding]; the loss is taken over the seeds; slots served from the
    # historical-embedding cache take its stale per-layer states instead
    # of expanding. `collate` leaves them None.
    seed_mask: Optional[torch.Tensor] = None     # [N] bool, loss mask
    node_global: Optional[torch.Tensor] = None   # [N] int32 global node id
    hist_mask: Optional[torch.Tensor] = None     # [N] bool, hist-served slot
    # [N] int32 deepest table layer the slot may refresh (-1 = none; the
    # loader keeps at most one slot per global id)
    refresh_upto: Optional[torch.Tensor] = None
    hist_states: Optional[torch.Tensor] = None   # [L-1, N, H] stale states

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[0]

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GraphBatch":
        return dataclasses.replace(self, **{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in dataclasses.fields(self)})


class GraphSample:
    """Host-side (numpy) single graph, pre-batching."""

    __slots__ = (
        "x", "pos", "senders", "receivers", "edge_attr", "edge_shifts",
        "y_graph", "y_node", "cell", "energy", "forces", "extras",
    )

    def __init__(
        self,
        x: np.ndarray,
        pos: np.ndarray,
        senders: np.ndarray,
        receivers: np.ndarray,
        edge_attr: Optional[np.ndarray] = None,
        edge_shifts: Optional[np.ndarray] = None,
        y_graph: Optional[np.ndarray] = None,
        y_node: Optional[np.ndarray] = None,
        cell: Optional[np.ndarray] = None,
        energy: Optional[np.ndarray] = None,
        forces: Optional[np.ndarray] = None,
        **extras: Any,
    ):
        self.x = np.asarray(x, dtype=np.float32)
        if self.x.ndim == 1:
            self.x = self.x[:, None]
        self.pos = np.asarray(pos, dtype=np.float32)
        self.senders = np.asarray(senders, dtype=np.int32)
        self.receivers = np.asarray(receivers, dtype=np.int32)
        self.edge_attr = None if edge_attr is None else np.asarray(
            edge_attr, dtype=np.float32)
        if self.edge_attr is not None and self.edge_attr.ndim == 1:
            self.edge_attr = self.edge_attr[:, None]
        self.edge_shifts = None if edge_shifts is None else np.asarray(
            edge_shifts, dtype=np.float32)
        self.y_graph = None if y_graph is None else np.atleast_1d(
            np.asarray(y_graph, dtype=np.float32)).reshape(-1)
        self.y_node = None if y_node is None else np.asarray(
            y_node, dtype=np.float32)
        if self.y_node is not None and self.y_node.ndim == 1:
            self.y_node = self.y_node[:, None]
        self.cell = None if cell is None else np.asarray(cell, dtype=np.float32)
        self.energy = None if energy is None else np.atleast_1d(
            np.asarray(energy, dtype=np.float32)).reshape(-1)
        self.forces = None if forces is None else np.asarray(
            forces, dtype=np.float32).reshape(-1, 3)
        self.extras = extras

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges(self) -> int:
        return self.senders.shape[0]


def _round_up(value: int, multiple: int) -> int:
    return int(math.ceil(value / multiple) * multiple)


class BucketSpec:
    """Rounds (n_node, n_edge, n_graph) to a bounded set of shapes: the
    next power-of-two-ish bucket (1, 1.5, 2, 3, 4, 6, 8, ...) times
    ``multiple``."""

    def __init__(self, multiple: int = 64):
        self.multiple = multiple

    def bucket(self, n: int) -> int:
        n = max(n, 1)
        m = self.multiple
        target = _round_up(n, m)
        p = m
        while p < target:
            if int(p * 1.5) >= target and (p * 3) % 2 == 0:
                return int(p * 1.5)
            p *= 2
        return p

    def shapes(self, n_node: int, n_edge: int, n_graph: int) -> Tuple[int, int, int]:
        return (self.bucket(n_node + 1), self.bucket(n_edge + 1), n_graph + 1)


_COLLATE_OPTIONAL_FIELDS = ("edge_attr", "edge_shifts", "y_graph", "y_node",
                            "cell", "energy", "forces")


def _validate_field_homogeneity(samples: Sequence[GraphSample]) -> None:
    """Every sample must carry sample 0's field schema and widths: the
    padded buffers are sized from sample 0."""
    ref = samples[0]
    for name in _COLLATE_OPTIONAL_FIELDS:
        want = getattr(ref, name) is not None
        for i, s in enumerate(samples):
            if (getattr(s, name) is not None) != want:
                a, b = ("present", "missing") if want else ("missing",
                                                           "present")
                raise ValueError(
                    f"collate: field '{name}' is {a} on sample 0 but {b} "
                    f"on sample {i} — all samples in a batch must share "
                    "one field schema")
    dims = [("x", lambda s: s.x.shape[1])]
    if ref.edge_attr is not None:
        dims.append(("edge_attr", lambda s: s.edge_attr.shape[1]))
    if ref.y_graph is not None:
        dims.append(("y_graph", lambda s: s.y_graph.shape[0]))
    if ref.y_node is not None:
        dims.append(("y_node", lambda s: s.y_node.shape[1]))
    for name, dim in dims:
        want_d = dim(ref)
        for i, s in enumerate(samples):
            if dim(s) != want_d:
                raise ValueError(
                    f"collate: field '{name}' has width {want_d} on "
                    f"sample 0 but {dim(s)} on sample {i} — all samples "
                    "in a batch must share one feature/label width")


def collate(
    samples: Sequence[GraphSample],
    n_node: Optional[int] = None,
    n_edge: Optional[int] = None,
    n_graph: Optional[int] = None,
    bucket: Optional[BucketSpec] = None,
) -> GraphBatch:
    """Concatenate samples and pad to (n_node, n_edge, n_graph). At least
    one padding graph and one padding node are always present. Returns CPU
    tensors."""
    if not samples:
        raise ValueError("collate: at least one sample is required")
    _validate_field_homogeneity(samples)
    tot_n = sum(s.num_nodes for s in samples)
    tot_e = sum(s.num_edges for s in samples)
    ng = len(samples)
    if bucket is None and (n_node is None or n_edge is None):
        bucket = BucketSpec()
    if n_node is None or n_edge is None or n_graph is None:
        bn, be, bg = bucket.shapes(tot_n, tot_e, ng)
        n_node = n_node or bn
        n_edge = n_edge or be
        n_graph = n_graph or bg
    if tot_n >= n_node or ng >= n_graph or tot_e > n_edge:
        raise ValueError(
            f"batch ({tot_n} nodes, {tot_e} edges, {ng} graphs) does not fit "
            f"padded shape ({n_node}, {n_edge}, {n_graph}); one padding "
            f"node/graph slot is required")

    fdim = samples[0].x.shape[1]
    x = np.zeros((n_node, fdim), np.float32)
    pos = np.zeros((n_node, 3), np.float32)
    senders = np.full((n_edge,), n_node - 1, np.int32)
    receivers = np.full((n_edge,), n_node - 1, np.int32)
    node_graph = np.full((n_node,), n_graph - 1, np.int32)
    node_mask = np.zeros((n_node,), bool)
    edge_mask = np.zeros((n_edge,), bool)
    graph_mask = np.zeros((n_graph,), bool)
    graph_mask[:ng] = True

    s0 = samples[0]
    edge_attr = (np.zeros((n_edge, s0.edge_attr.shape[1]), np.float32)
                 if s0.edge_attr is not None else None)
    edge_shifts = (np.zeros((n_edge, 3), np.float32)
                   if s0.edge_shifts is not None else None)
    y_graph = (np.zeros((n_graph, s0.y_graph.shape[0]), np.float32)
               if s0.y_graph is not None else None)
    y_node = (np.zeros((n_node, s0.y_node.shape[1]), np.float32)
              if s0.y_node is not None else None)
    cell = np.zeros((n_graph, 3, 3), np.float32) if s0.cell is not None else None
    energy = np.zeros((n_graph, 1), np.float32) if s0.energy is not None else None
    forces = np.zeros((n_node, 3), np.float32) if s0.forces is not None else None

    no, eo = 0, 0
    for gi, s in enumerate(samples):
        n, e = s.num_nodes, s.num_edges
        x[no:no + n] = s.x
        pos[no:no + n] = s.pos
        senders[eo:eo + e] = s.senders + no
        receivers[eo:eo + e] = s.receivers + no
        node_graph[no:no + n] = gi
        node_mask[no:no + n] = True
        edge_mask[eo:eo + e] = True
        if edge_attr is not None:
            edge_attr[eo:eo + e] = s.edge_attr
        if edge_shifts is not None:
            edge_shifts[eo:eo + e] = s.edge_shifts
        if y_graph is not None:
            y_graph[gi] = s.y_graph
        if y_node is not None:
            y_node[no:no + n] = s.y_node
        if cell is not None:
            cell[gi] = s.cell
        if energy is not None:
            energy[gi, 0] = s.energy[0]
        if forces is not None:
            forces[no:no + n] = s.forces
        no += n
        eo += e

    opt = lambda a: None if a is None else torch.from_numpy(a)
    return GraphBatch(
        x=opt(x), pos=opt(pos), senders=opt(senders),
        receivers=opt(receivers), node_graph=opt(node_graph),
        node_mask=opt(node_mask), edge_mask=opt(edge_mask),
        graph_mask=opt(graph_mask), y_graph=opt(y_graph), y_node=opt(y_node),
        edge_attr=opt(edge_attr), edge_shifts=opt(edge_shifts), cell=opt(cell),
        energy=opt(energy), forces=opt(forces),
    )


def padding_batch(proto: GraphSample, n_node: int, n_edge: int,
                  n_graph: int) -> GraphBatch:
    """An all-padding batch with `proto`'s fields (the JAX loader's empty
    shard): every value zero, every id the last (padding) node or graph
    slot, every mask False."""
    b = collate([proto], n_node=n_node, n_edge=n_edge, n_graph=n_graph)
    fill = {"senders": n_node - 1, "receivers": n_node - 1,
            "node_graph": n_graph - 1}
    return b.replace(**{
        f.name: (None if getattr(b, f.name) is None
                 else torch.full_like(getattr(b, f.name),
                                      fill.get(f.name, 0)))
        for f in dataclasses.fields(b)})


def build_neighbor_tables(senders: np.ndarray, receivers: np.ndarray,
                          edge_mask: np.ndarray, n_node: int, n_edge: int,
                          k: Optional[int] = None, k_multiple: int = 8):
    """Receiver-major fixed-degree neighbor tables from a padded edge list:
    (nbr [N, K], nbr_edge [N, K], nbr_mask [N, K]). Slot k of node i holds
    the sender and edge id of i's k-th in-edge (in edge order); padding
    slots point at the padding node/edge with mask False. K is the max
    in-degree rounded up to `k_multiple`, or the explicit `k`."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    real = np.asarray(edge_mask, bool)
    deg = np.bincount(receivers[real], minlength=n_node)
    kmax = int(deg.max()) if deg.size else 0
    if k is None:
        k = max(k_multiple, _round_up(max(kmax, 1), k_multiple))
    elif kmax > k:
        raise ValueError(f"max in-degree {kmax} exceeds neighbor budget {k}")

    nbr = np.full((n_node, k), n_node - 1, np.int32)
    nbr_edge = np.full((n_node, k), n_edge - 1, np.int32)
    nbr_mask = np.zeros((n_node, k), bool)
    # stable-sort real edges by receiver; an edge's slot is its rank
    # within its receiver run
    eids = np.nonzero(real)[0]
    if eids.size:
        order = np.argsort(receivers[eids], kind="stable")
        e_sorted = eids[order]
        r_sorted = receivers[e_sorted]
        run_start = np.zeros(e_sorted.size, np.int64)
        run_start[1:] = np.cumsum(r_sorted[1:] != r_sorted[:-1])
        first_of_run = np.concatenate(
            ([0], np.nonzero(r_sorted[1:] != r_sorted[:-1])[0] + 1))
        slots = np.arange(e_sorted.size) - first_of_run[run_start]
        nbr[r_sorted, slots] = senders[e_sorted]
        nbr_edge[r_sorted, slots] = e_sorted
        nbr_mask[r_sorted, slots] = True
    return nbr, nbr_edge, nbr_mask


def neighbor_budget_for_dataset(samples, k_multiple: int = 8) -> int:
    """Dataset-level neighbor-table width: the max in-degree over all
    samples (at least 1) rounded up to `k_multiple`, so every batch of the
    dataset shares one [N, K] shape."""
    kmax = 0
    for s in samples:
        if s.num_edges:
            deg = np.bincount(np.asarray(s.receivers), minlength=s.num_nodes)
            kmax = max(kmax, int(deg.max()))
    return max(k_multiple, _round_up(max(kmax, 1), k_multiple))


def with_neighbor_format(batch: GraphBatch, k: Optional[int] = None,
                         k_multiple: int = 8) -> GraphBatch:
    """Attach neighbor tables (built on the host) to a batch; the tables
    land on the batch's device."""
    nbr, nbr_edge, nbr_mask = build_neighbor_tables(
        batch.senders.cpu().numpy(), batch.receivers.cpu().numpy(),
        batch.edge_mask.cpu().numpy(), batch.num_nodes, batch.num_edges,
        k=k, k_multiple=k_multiple)
    dev = batch.x.device
    return batch.replace(nbr=torch.from_numpy(nbr).to(dev),
                         nbr_edge=torch.from_numpy(nbr_edge).to(dev),
                         nbr_mask=torch.from_numpy(nbr_mask).to(dev))
