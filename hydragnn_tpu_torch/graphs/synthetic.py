"""Synthetic molecule-sized graphs from a numpy seed, for tests and for
`chip_smoke.py` while the CSCE molecules are not in the repository.

Each molecule has `min_atoms`..`max_atoms` atoms at roughly unit density
in a cube, edges j -> i for every pair closer than `cutoff`, each atom
keeping at most `max_in_degree` nearest in-edges (ties broken by sender
index), and one graph-level target. About one molecule in eight has an
atom moved far away, so the data holds isolated nodes.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .batch import GraphSample


def synthetic_molecules(num: int, seed: int = 0, min_atoms: int = 10,
                        max_atoms: int = 60, num_features: int = 12,
                        max_in_degree: int = 20,
                        cutoff: float = 1.8) -> List[GraphSample]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        n = int(rng.integers(min_atoms, max_atoms + 1))
        pos = rng.random((n, 3)) * n ** (1.0 / 3.0)
        if rng.random() < 0.125:
            pos[int(rng.integers(n))] += 100.0
        x = rng.random((n, num_features)).astype(np.float32)
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        senders, receivers = [], []
        for i in range(n):
            cand = np.nonzero(d2[i] < cutoff ** 2)[0]
            cand = cand[np.lexsort((cand, d2[i, cand]))][:max_in_degree]
            senders.append(np.sort(cand))
            receivers.append(np.full(cand.size, i))
        out.append(GraphSample(
            x=x, pos=pos.astype(np.float32),
            senders=np.concatenate(senders).astype(np.int32),
            receivers=np.concatenate(receivers).astype(np.int32),
            y_graph=rng.normal(size=1).astype(np.float32)))
    return out
