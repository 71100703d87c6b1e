"""Fixed-shape sampled training on one giant graph (counterpart:
hydragnn_tpu/preprocess/sampling.py, whose host side this module keeps
bit for bit: the plan, every batch of every epoch at any world size and
rank, the fetch accounting).

GraphSAGE-style sampling trains node tasks on k-hop subgraphs around seed
nodes. The fanout is fixed per hop, so every sampled subgraph has the same
shapes: on the card the train step is one CUDA graph for the whole run.
The computation graph is a padded `GraphBatch` whose node slots are laid
out ``[seeds | hop1 | hop2 | ... | padding]`` with explicit edges, so it
goes through the real conv stacks and heads; the loss is masked to the
seeds (``GraphBatch.seed_mask``).

* `NeighborSamplingLoader`: seed minibatches from a global permutation
  that is a pure function of (epoch, seed), rank r of W taking batches
  r, r + W, ...; each batch's sampling RNG is keyed by its global index,
  never the rank, so any world size sees the same global batches. Built
  in the background by default (datasets/async_loader.py).
* `NodeFeatureStore`: features and labels gathered per minibatch by
  global id, with local / remote byte accounting against a partition map
  (parallel/partition.py), in memory or from a content-addressed array
  shard (preprocess/cache.py).
* `HistTables`: the historical-embedding cache (DistGNN): per-layer stale
  states and version stamps, tensors on an explicit device. With
  staleness K > 0, remote in-neighbours beyond hop 0 are not expanded:
  their states come from the tables (`models/base.BaseStack.encode`
  applies them layer by layer) and their features from the resident
  feature table, so a step fetches nothing across partitions; each rank
  refreshes the rows it owns from its fresh states every K steps, inside
  the captured step (`train/train_step.make_sampled_train_step`). K = 0
  is exact full expansion with no cache.

`sample_in_neighbors` keeps its per-node loop and `rng.choice` calls in
the JAX package's order: vectorising it would change the RandomState
stream, and so every batch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..datasets.async_loader import background_iterate, resolve_async_workers
from ..graphs.batch import GraphBatch
from ..parallel.partition import (_splitmix64, partition_fingerprint,
                                  partition_nodes)
from ..telemetry.sampling import record_sampled_batch


class CSRGraph:
    """In-neighbour CSR adjacency: for node i, senders[indptr[i]:
    indptr[i+1]] are its in-edges' sources.

    The edge list is checked up front: an out-of-range receiver would
    silently shift `indptr` (bincount counts past num_nodes) and so every
    later node's slice; an empty edge list builds an all-zero indptr."""

    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 num_nodes: int):
        senders = np.asarray(senders, np.int64).reshape(-1)
        receivers = np.asarray(receivers, np.int64).reshape(-1)
        num_nodes = int(num_nodes)
        if num_nodes < 0:
            raise ValueError(f"num_nodes must be >= 0, got {num_nodes}")
        if senders.shape != receivers.shape:
            raise ValueError(
                f"senders ({senders.shape}) and receivers "
                f"({receivers.shape}) must have the same length")
        for name, arr in (("senders", senders), ("receivers", receivers)):
            if arr.size == 0:
                continue
            lo, hi = int(arr.min()), int(arr.max())
            if lo < 0 or hi >= num_nodes:
                bad = lo if lo < 0 else hi
                raise ValueError(
                    f"CSRGraph: {name} contains node id {bad} outside "
                    f"[0, {num_nodes}); an out-of-range receiver would "
                    "silently corrupt indptr (bincount truncation) and "
                    "missample every later node — fix the edge list or "
                    "raise num_nodes")
        order = np.argsort(receivers, kind="stable")
        self.senders = senders[order].astype(np.int32)
        self.indptr = np.zeros(num_nodes + 1, np.int64)
        counts = np.bincount(receivers, minlength=num_nodes)
        np.cumsum(counts, out=self.indptr[1:])
        self.num_nodes = num_nodes

    @property
    def num_edges(self) -> int:
        return int(self.senders.size)

    def sample_in_neighbors(self, nodes: np.ndarray, fanout: int,
                            rng: np.random.RandomState,
                            skip: Optional[np.ndarray] = None):
        """[B] nodes -> ([B, fanout] sampled senders, [B, fanout] mask). A
        node of degree <= fanout takes all its in-neighbours; a higher one
        `fanout` of them uniformly without replacement. Rows where `skip`
        is True (cache-served frontier nodes) stay empty."""
        B = len(nodes)
        nbr = np.zeros((B, fanout), np.int32)
        mask = np.zeros((B, fanout), bool)
        for b, n in enumerate(nodes):
            if skip is not None and skip[b]:
                continue
            lo, hi = self.indptr[n], self.indptr[n + 1]
            deg = int(hi - lo)
            if deg == 0:
                continue
            if deg <= fanout:
                take = self.senders[lo:hi]
            else:
                take = self.senders[lo + rng.choice(deg, fanout,
                                                    replace=False)]
            nbr[b, :len(take)] = take
            mask[b, :len(take)] = True
        return nbr, mask


# ------------------------------------------------------------- seed plan --
def seed_plan(num_seeds: int, epoch: int, seed: int) -> np.ndarray:
    """The global seed permutation of an epoch: a pure function of
    (epoch, seed), the same on every rank at every world size."""
    mixed = _splitmix64(np.uint64((np.int64(seed) << np.int64(20))
                                  ^ np.int64(epoch)))
    rng = np.random.RandomState(int(mixed) % (2 ** 31 - 1))
    return rng.permutation(int(num_seeds)).astype(np.int64)


def _batch_rng(seed: int, epoch: int, global_batch: int
               ) -> np.random.RandomState:
    """The sampling RNG of one global batch, whichever rank builds it."""
    mixed = _splitmix64(np.uint64((np.int64(seed) << np.int64(40))
                                  ^ (np.int64(epoch) << np.int64(20))
                                  ^ np.int64(global_batch)))
    return np.random.RandomState(int(mixed) % (2 ** 31 - 1))


# --------------------------------------------------------------- sampling --
@dataclasses.dataclass
class SampledSubgraph:
    """One k-hop computation graph with fixed shapes. ``node_ids`` lays
    out ``[seeds | hop1 | ... | hopK]`` (occurrences, not deduplicated).
    ``hop_tables[h] = (local, mask)``: ``local[i, k]`` is the flat
    position in node_ids of frontier node i's k-th sampled in-neighbour.
    ``halted`` marks occurrences served from the historical cache
    (remote, beyond hop 0, K > 0), whose fanout rows are masked."""
    node_ids: np.ndarray                       # [n_total] int64 global ids
    hop_of: np.ndarray                         # [n_total] int32 hop depth
    halted: np.ndarray                         # [n_total] bool
    hop_tables: List[Tuple[np.ndarray, np.ndarray]]
    offsets: np.ndarray                        # [K + 2] block offsets

    @property
    def num_seeds(self) -> int:
        return int(self.offsets[1])


def sample_khop_subgraph(csr: CSRGraph, seeds: np.ndarray,
                         fanouts: Sequence[int],
                         rng: np.random.RandomState,
                         owner: Optional[np.ndarray] = None,
                         rank: int = 0,
                         expand_remote: bool = True) -> SampledSubgraph:
    """The k-hop computation graph of `seeds` at fixed fanouts: frontier
    sizes B_0 = len(seeds), B_{h+1} = B_h * fanout_h. With
    ``expand_remote=False`` (historical mode) frontier nodes beyond hop 0
    whose owner is not `rank` are halted, not expanded; seeds always
    expand."""
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    frontiers: List[np.ndarray] = [seeds]
    halts: List[np.ndarray] = [np.zeros(len(seeds), bool)]
    tables = []
    for f in fanouts:
        cur, cur_halt = frontiers[-1], halts[-1]
        nbr, mask = csr.sample_in_neighbors(cur, int(f), rng,
                                            skip=cur_halt)
        tables.append((nbr, mask))
        flat = nbr.reshape(-1).astype(np.int64)
        fmask = mask.reshape(-1)
        if owner is not None and not expand_remote:
            new_halt = fmask & (owner[flat] != rank)
        else:
            new_halt = np.zeros(flat.size, bool)
        frontiers.append(flat)
        halts.append(new_halt)
    node_ids = np.concatenate(frontiers)
    halted = np.concatenate(halts)
    offsets = np.cumsum([0] + [fr.size for fr in frontiers])
    hop_of = np.concatenate(
        [np.full(fr.size, h, np.int32) for h, fr in enumerate(frontiers)])
    hop_tables = []
    for h, (nbr, mask) in enumerate(tables):
        # occurrence j of hop h+1's block sits at offsets[h+1] + j
        local = (offsets[h + 1]
                 + np.arange(nbr.size, dtype=np.int32).reshape(nbr.shape))
        hop_tables.append((local, mask))
    return SampledSubgraph(node_ids=node_ids, hop_of=hop_of, halted=halted,
                           hop_tables=hop_tables,
                           offsets=np.asarray(offsets, np.int64))


def refresh_allowance(sub: SampledSubgraph, owner: Optional[np.ndarray],
                      rank: int, num_layers: int) -> np.ndarray:
    """[n_total] int32: the deepest table layer t (1-based; the tables
    hold the post-layer states of layers 1..L-1) each occurrence may
    refresh, -1 for none. A hop-h occurrence's layer-t state is exact for
    t <= L - h. Only occurrences this rank owns and computed fresh
    qualify, and of each global id only one keeps its allowance (the
    deepest, ties to the first occurrence), so the refresh scatter's
    indices are unique."""
    n = sub.node_ids.size
    allow = np.minimum(num_layers - sub.hop_of, num_layers - 1)
    qualify = (~sub.halted) & (allow >= 1)
    if owner is not None:
        qualify &= owner[sub.node_ids] == rank
    out = np.full(n, -1, np.int32)
    cand = np.flatnonzero(qualify)
    if cand.size:
        # lexsort's last key is primary: by node id, deepest allowance
        # first, earliest occurrence on ties
        ordkey = np.lexsort((cand, -allow[cand], sub.node_ids[cand]))
        cs = cand[ordkey]
        first = np.ones(cs.size, bool)
        first[1:] = sub.node_ids[cs[1:]] != sub.node_ids[cs[:-1]]
        keep = cs[first]
        out[keep] = allow[keep]
    return out


# ------------------------------------------------------ batch construction --
def build_sampled_batch(sub: SampledSubgraph, x_rows: np.ndarray,
                        y_seed: np.ndarray, *, num_nodes_global: int,
                        num_layers: Optional[int] = None,
                        hist: bool = False,
                        owner: Optional[np.ndarray] = None,
                        rank: int = 0) -> GraphBatch:
    """The padded static-shape `GraphBatch` (CPU tensors) of a sampled
    subgraph: the last node slot is the padding node, masked fanout slots
    become padding self-edges (plus one padding edge always), the
    subgraph is graph 0 of 2, and the loss mask is ``seed_mask``.
    ``x_rows`` are per-occurrence features (halted rows may be zeros: the
    historical step takes them from the feature table)."""
    n_total = sub.node_ids.size
    B = sub.num_seeds
    N = n_total + 1
    F = x_rows.shape[1]
    y_seed = np.asarray(y_seed, np.float32)
    if y_seed.ndim == 1:
        y_seed = y_seed[:, None]
    T = y_seed.shape[1]

    x = np.zeros((N, F), np.float32)
    x[:n_total] = x_rows
    y_node = np.zeros((N, T), np.float32)
    y_node[:B] = y_seed

    send_parts, recv_parts, mask_parts = [], [], []
    for h, (local, mask) in enumerate(sub.hop_tables):
        Bh, fh = local.shape
        recv = (sub.offsets[h]
                + np.repeat(np.arange(Bh, dtype=np.int64), fh))
        send = local.reshape(-1).astype(np.int64)
        m = mask.reshape(-1)
        send_parts.append(np.where(m, send, N - 1))
        recv_parts.append(np.where(m, recv, N - 1))
        mask_parts.append(m)
    send_parts.append(np.asarray([N - 1], np.int64))
    recv_parts.append(np.asarray([N - 1], np.int64))
    mask_parts.append(np.asarray([False]))
    senders = np.concatenate(send_parts).astype(np.int32)
    receivers = np.concatenate(recv_parts).astype(np.int32)
    edge_mask = np.concatenate(mask_parts)

    node_mask = np.ones(N, bool)
    node_mask[N - 1] = False
    seed_mask = np.zeros(N, bool)
    seed_mask[:B] = True
    node_graph = np.zeros(N, np.int32)
    node_graph[N - 1] = 1
    graph_mask = np.asarray([True, False])

    node_global = np.concatenate(
        [sub.node_ids, [num_nodes_global]]).astype(np.int32)
    hist_mask = None
    refresh_upto = None
    if hist:
        if num_layers is None:
            num_layers = len(sub.hop_tables)
        hist_mask = np.concatenate([sub.halted, [False]])
        refresh_upto = np.concatenate(
            [refresh_allowance(sub, owner, rank, int(num_layers)),
             [-1]]).astype(np.int32)

    opt = lambda a: None if a is None else torch.from_numpy(a)
    return GraphBatch(
        x=opt(x), pos=torch.zeros((N, 3), dtype=torch.float32),
        senders=opt(senders), receivers=opt(receivers),
        node_graph=opt(node_graph), node_mask=opt(node_mask),
        edge_mask=opt(edge_mask), graph_mask=opt(graph_mask),
        y_node=opt(y_node), seed_mask=opt(seed_mask),
        node_global=opt(node_global), hist_mask=opt(hist_mask),
        refresh_upto=opt(refresh_upto))


# --------------------------------------------------- historical embeddings --
@dataclasses.dataclass
class HistTables:
    """The historical-embedding cache on one device: stale per-layer
    states and version stamps, updated in place by the historical train
    step. Row Ng is the dump row: refreshes that do not qualify (and every
    refresh while the flag is off) write it; nothing live reads it."""
    feat: torch.Tensor      # [Ng+1, F] float32 static features
    layers: torch.Tensor    # [L-1, Ng+1, H] float32 stale post-layer states
    versions: torch.Tensor  # [Ng+1] int32 refresh step stamps

    def tensors(self) -> List[torch.Tensor]:
        return [self.feat, self.layers, self.versions]

    def copy(self) -> "HistTables":
        return HistTables(*(t.detach().clone() for t in self.tensors()))

    def restore(self, snapshot: "HistTables") -> "HistTables":
        """Copy a snapshot's values into these tensors, in place."""
        with torch.no_grad():
            for t, s in zip(self.tensors(), snapshot.tensors()):
                t.copy_(s)
        return self


def init_hist_tables(features: np.ndarray, hidden_dim: int,
                     num_layers: int, device="cuda") -> HistTables:
    """Fresh tables on `device`: ``feat`` filled once from the features
    (static: only hidden states go stale), ``layers`` and ``versions``
    zero."""
    features = np.asarray(features, np.float32)
    ng, f = features.shape
    feat = np.zeros((ng + 1, f), np.float32)
    feat[:ng] = features
    t = max(int(num_layers) - 1, 0)
    return HistTables(
        feat=torch.from_numpy(feat).to(device),
        layers=torch.zeros((t, ng + 1, int(hidden_dim)), dtype=torch.float32,
                           device=device),
        versions=torch.zeros((ng + 1,), dtype=torch.int32, device=device))


# ------------------------------------------------------------ feature store --
class NodeFeatureStore:
    """Partitioned node features and labels, gathered per minibatch by
    global id with local / remote byte accounting; in memory or from a
    memory-mapped array shard (`open_cached` / `build_cached`)."""

    def __init__(self, x: np.ndarray, y_node: np.ndarray,
                 owner: Optional[np.ndarray] = None, rank: int = 0):
        self.x = np.asarray(x)
        self.y = np.asarray(y_node)
        if self.y.ndim == 1:
            self.y = self.y[:, None]
        self.owner = (np.zeros(len(self.x), np.int32) if owner is None
                      else np.asarray(owner, np.int32))
        self.rank = int(rank)
        self.local_bytes = 0
        self.remote_bytes = 0

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def feat_dim(self) -> int:
        return int(self.x.shape[1])

    @property
    def label_dim(self) -> int:
        return int(self.y.shape[1])

    def _count(self, ids: np.ndarray, row_bytes: int) -> None:
        remote = int(np.sum(self.owner[ids] != self.rank))
        self.remote_bytes += remote * row_bytes
        self.local_bytes += (ids.size - remote) * row_bytes

    def gather_features(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        self._count(ids, int(self.x.itemsize * self.x.shape[1]))
        return np.ascontiguousarray(self.x[ids], dtype=np.float32)

    def gather_labels(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        self._count(ids, int(self.y.itemsize * self.y.shape[1]))
        return np.ascontiguousarray(self.y[ids], dtype=np.float32)

    def fetch_stats(self) -> Dict[str, int]:
        return {"local_bytes": int(self.local_bytes),
                "remote_bytes": int(self.remote_bytes)}

    @classmethod
    def build_cached(cls, cache_dir: str, key: str, x: np.ndarray,
                     y_node: np.ndarray, owner: np.ndarray,
                     rank: int = 0) -> "NodeFeatureStore":
        """Write the store as an array shard, then reopen it mapped."""
        from .cache import save_array_shard
        y_node = np.asarray(y_node)
        if y_node.ndim == 1:
            y_node = y_node[:, None]
        save_array_shard(cache_dir, key, {
            "x": np.asarray(x, np.float32),
            "y_node": np.asarray(y_node, np.float32),
            "owner": np.asarray(owner, np.int32)})
        return cls.open_cached(cache_dir, key, rank=rank)

    @classmethod
    def open_cached(cls, cache_dir: str, key: str, rank: int = 0,
                    verify: bool = True) -> "NodeFeatureStore":
        from .cache import load_array_shard
        arrays, _ = load_array_shard(cache_dir, key, verify=verify)
        return cls(arrays["x"], arrays["y_node"], arrays["owner"],
                   rank=rank)


# ------------------------------------------------------------------ loader --
class NeighborSamplingLoader:
    """Fixed-shape sampled `GraphBatch`es (CPU tensors) for node-level
    training on one big graph.

    The plan: ``seed_plan(epoch, seed)`` permutes the train nodes,
    consecutive size-B slices are the ``num_global_batches`` batches (a
    trailing partial one dropped), and rank r of W takes batches r, r+W,
    ...; each batch is sampled with the RNG of its global index."""

    def __init__(self, x: Optional[np.ndarray] = None,
                 senders: np.ndarray = None, receivers: np.ndarray = None,
                 y_node: Optional[np.ndarray] = None,
                 batch_size: int = 32, fanouts: Sequence[int] = (8, 8),
                 shuffle: bool = True, seed: int = 0,
                 train_nodes: Optional[np.ndarray] = None, *,
                 store: Optional[NodeFeatureStore] = None,
                 rank: int = 0, world: int = 1,
                 num_partitions: int = 1, partition_mode: str = "range",
                 staleness_k: int = 0, num_layers: Optional[int] = None,
                 async_workers: Optional[int] = None):
        if store is None:
            if x is None or y_node is None:
                raise ValueError(
                    "NeighborSamplingLoader needs either (x, y_node) "
                    "arrays or a prebuilt NodeFeatureStore")
            owner = partition_nodes(len(np.asarray(x)),
                                    int(num_partitions), partition_mode,
                                    seed=int(seed))
            store = NodeFeatureStore(x, y_node, owner, rank=rank)
        self.store = store
        self.owner = store.owner
        self.csr = CSRGraph(senders, receivers, store.num_nodes)
        self.batch_size = int(batch_size)
        self.fanouts = tuple(int(f) for f in fanouts)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.rank = int(rank)
        self.world = max(int(world), 1)
        self.num_partitions = int(num_partitions)
        self.partition_mode = str(partition_mode)
        self.staleness_k = int(staleness_k)
        self.num_layers = int(num_layers if num_layers is not None
                              else len(self.fanouts))
        self.async_workers = resolve_async_workers(async_workers)
        self.epoch = 0
        self.train_nodes = (np.arange(store.num_nodes, dtype=np.int64)
                            if train_nodes is None
                            else np.asarray(train_nodes, np.int64))
        if len(self.train_nodes) < self.batch_size:
            raise ValueError(
                f"batch_size={self.batch_size} exceeds the "
                f"{len(self.train_nodes)} available seed nodes — fixed "
                "shapes need at least one full batch")
        self.batches_built = 0
        # the background stream's overlap accounting (background_iterate
        # mutates it in place)
        self.overlap_stats: Dict[str, float] = {}

    # ----------------------------------------------------------- the plan --
    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    @property
    def hist_mode(self) -> bool:
        return self.staleness_k > 0

    @property
    def num_global_batches(self) -> int:
        return len(self.train_nodes) // self.batch_size

    def rank_batches(self) -> List[int]:
        """This rank's global batch indices."""
        return list(range(self.rank, self.num_global_batches, self.world))

    def __len__(self) -> int:
        return len(self.rank_batches())

    def epoch_order(self, epoch: Optional[int] = None) -> np.ndarray:
        ep = self.epoch if epoch is None else int(epoch)
        if not self.shuffle:
            return self.train_nodes
        return self.train_nodes[seed_plan(len(self.train_nodes), ep,
                                          self.seed)]

    def plan_fingerprint(self) -> str:
        """sha256 over everything that decides the global batch sequence,
        the same at every world size (the JAX package's string for the
        same inputs)."""
        h = hashlib.sha256()
        h.update(json.dumps({
            "batch_size": self.batch_size, "fanouts": list(self.fanouts),
            "shuffle": self.shuffle, "seed": self.seed,
            "num_layers": self.num_layers,
            "staleness_k": self.staleness_k,
            "partitions": partition_fingerprint(
                self.store.num_nodes, self.num_partitions,
                self.partition_mode, self.seed),
            "scheme": "sample-plan-v1"}, sort_keys=True).encode())
        h.update(np.ascontiguousarray(self.train_nodes).tobytes())
        h.update(self.epoch_order(0).tobytes())
        return h.hexdigest()[:32]

    # ------------------------------------------------------------ batches --
    def _build_batch(self, order: np.ndarray, gb: int) -> GraphBatch:
        rng = _batch_rng(self.seed, self.epoch, gb)
        seeds = order[gb * self.batch_size:(gb + 1) * self.batch_size]
        sub = sample_khop_subgraph(
            self.csr, seeds, self.fanouts, rng, owner=self.owner,
            rank=self.rank, expand_remote=not self.hist_mode)
        x_rows = np.zeros((sub.node_ids.size, self.store.feat_dim),
                          np.float32)
        fresh = ~sub.halted
        x_rows[fresh] = self.store.gather_features(sub.node_ids[fresh])
        y_seed = self.store.gather_labels(seeds)
        batch = build_sampled_batch(
            sub, x_rows, y_seed, num_nodes_global=self.store.num_nodes,
            num_layers=self.num_layers, hist=self.hist_mode,
            owner=self.owner, rank=self.rank)
        self.batches_built += 1
        record_sampled_batch(
            num_seeds=len(seeds), num_nodes=int(sub.node_ids.size),
            hist_served=int(np.sum(sub.halted)),
            fetch_stats=self.store.fetch_stats())
        return batch

    def __iter__(self):
        order = self.epoch_order()

        def gen():
            for gb in self.rank_batches():
                yield self._build_batch(order, gb)

        if self.async_workers > 0:
            return background_iterate(gen(), depth=self.async_workers + 1,
                                      stats=self.overlap_stats)
        return gen()

    def sampler_overlap_frac(self) -> float:
        """The fraction of consumed batches already waiting in the
        background queue (1.0: sampling hid fully behind the steps; 0.0
        before any background iteration)."""
        items = self.overlap_stats.get("items", 0)
        if not items:
            return 0.0
        return self.overlap_stats["ready_items"] / items

    def fetch_stats(self) -> Dict[str, float]:
        """Cumulative gather bytes; `remote_bytes` is the cross-partition
        volume the historical cache removes. In background mode
        `batches` counts what the producers built, which may run ahead of
        what was consumed."""
        stats = dict(self.store.fetch_stats())
        n = max(self.batches_built, 1)
        stats["batches"] = self.batches_built
        stats["remote_bytes_per_batch"] = stats["remote_bytes"] / n
        stats["local_bytes_per_batch"] = stats["local_bytes"] / n
        stats["sampler_overlap_frac"] = self.sampler_overlap_frac()
        return stats
