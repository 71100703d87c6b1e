"""Dataset splitting and loader creation (counterpart:
hydragnn_tpu/preprocess/load_data.py: `split_dataset`, `loader_budgets`,
`create_dataloaders`, fixed-shape single-shard).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..datasets.loader import GraphDataLoader, padded_budgets
from ..graphs.batch import GraphSample, neighbor_budget_for_dataset


def split_dataset(dataset: Sequence[GraphSample], perc_train: float,
                  stratify_splitting: bool = False, seed: int = 0):
    """Random or composition-stratified (train, val, test) split; val and
    test each get (1 - perc_train) / 2. The random split permutes with
    `np.random.RandomState(seed)`; the stratified one groups samples by
    the multiset of their first input feature (rounded to 6 decimals) and
    splits each group in sorted key order."""
    n = len(dataset)
    if not stratify_splitting:
        order = np.random.RandomState(seed).permutation(n)
        return _split_by_order(dataset, order, perc_train)
    cats: Dict[tuple, List[int]] = {}
    for i, s in enumerate(dataset):
        types = np.round(np.asarray(s.x[:, 0]), 6)
        vals, counts = np.unique(types, return_counts=True)
        key = tuple(zip(vals.tolist(), counts.tolist()))
        cats.setdefault(key, []).append(i)
    rng = np.random.RandomState(seed)
    tr, va, te = [], [], []
    for key in sorted(cats.keys()):
        idx = np.asarray(cats[key])
        rng.shuffle(idx)
        ntr = int(round(len(idx) * perc_train))
        nva = int(round(len(idx) * (1 - perc_train) / 2))
        tr += idx[:ntr].tolist()
        va += idx[ntr:ntr + nva].tolist()
        te += idx[ntr + nva:].tolist()
    return ([dataset[i] for i in tr], [dataset[i] for i in va],
            [dataset[i] for i in te])


def _split_by_order(dataset, order, perc_train):
    n = len(order)
    ntr = int(round(n * perc_train))
    nva = int(round(n * (1 - perc_train) / 2))
    return ([dataset[i] for i in order[:ntr]],
            [dataset[i] for i in order[ntr:ntr + nva]],
            [dataset[i] for i in order[ntr + nva:]])


def loader_budgets(all_samples, graphs_per_batch: int,
                   neighbor_format: bool = False):
    """(n_node, n_edge, K or None): the padded shapes every batch of the
    run shares — room for `graphs_per_batch` of the largest graphs,
    bucketed by BucketSpec(64) — and the dense layout's K."""
    n_node, n_edge = padded_budgets(all_samples, graphs_per_batch)
    return (n_node, n_edge,
            neighbor_budget_for_dataset(all_samples) if neighbor_format
            else None)


def create_dataloaders(trainset, valset, testset, batch_size: int,
                       neighbor_format: bool = False):
    """One fixed-shape loader per split (seed 0), all three on the shape
    of the largest graph of any split (and one K), so the model sees one
    batch shape; the train loader shuffles and drops its last partial
    batch."""
    all_samples = list(trainset) + list(valset) + list(testset)
    n_node, n_edge, k = loader_budgets(all_samples, max(batch_size, 1),
                                       neighbor_format)

    def mk(ds, shuffle):
        return GraphDataLoader(ds, batch_size, shuffle=shuffle, n_node=n_node,
                               n_edge=n_edge, neighbor_format=neighbor_format,
                               neighbor_k=k)
    return mk(trainset, True), mk(valset, False), mk(testset, False)
