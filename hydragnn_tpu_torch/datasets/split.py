"""Random or composition-stratified (train, val, test) splits
(counterpart: hydragnn_tpu/preprocess/load_data.py `split_dataset`)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..graphs.batch import GraphSample


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
