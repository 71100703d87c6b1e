"""Synthetic graphs from a numpy seed, for tests and for `chip_smoke.py`.

`synthetic_molecules` stands in for the CSCE molecules, which are not in
the repository. Each molecule has `min_atoms`..`max_atoms` atoms at
roughly unit density in a cube, edges j -> i for every pair closer than
`cutoff`, each atom keeping at most `max_in_degree` nearest in-edges (ties
broken by sender index), and one graph-level target. About one molecule in
eight has an atom moved far away, so the data holds isolated nodes.

`lj_configurations` is the Lennard-Jones data of
examples/LennardJones/lj_data.py (`generate_lj_dataset`), bitwise: the
same physics on the port's GraphSample.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .batch import GraphSample
from .radius import radius_graph_pbc


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


def lj_energy_forces(pos: np.ndarray, cell: np.ndarray, cutoff: float,
                     epsilon: float = 1.0, sigma: float = 1.0):
    """Total Lennard-Jones energy, per-atom forces and the periodic edges
    (senders, receivers, shifts) within `cutoff`."""
    send, recv, shifts = radius_graph_pbc(pos, cell, cutoff)
    disp = pos[send] + shifts - pos[recv]
    r2 = np.sum(disp * disp, axis=1)
    r2 = np.maximum(r2, 1e-12)
    inv6 = (sigma * sigma / r2) ** 3
    inv12 = inv6 * inv6
    # every pair appears once per direction: half of the sum
    e_pair = 4.0 * epsilon * (inv12 - inv6)
    energy = 0.5 * float(e_pair.sum())
    coef = 4.0 * epsilon * (12.0 * inv12 - 6.0 * inv6) / r2
    f_edge = coef[:, None] * disp
    forces = np.zeros_like(pos)
    np.add.at(forces, recv, -f_edge)
    return energy, forces, (send, recv, shifts)


def lj_configurations(num_configs: int, atoms_per_dim: int = 3,
                      lattice: float = 1.2, jitter: float = 0.08,
                      cutoff: float = 2.0, seed: int = 0,
                      normalize: bool = True) -> List[GraphSample]:
    """Perturbed simple-cubic cells of atoms_per_dim³ atoms under periodic
    boundaries, with their LJ energies and forces; `normalize` scales
    energies to zero mean and unit spread and forces by the same factor,
    so that forces stay -dE/dpos."""
    rng = np.random.RandomState(seed)
    n = atoms_per_dim ** 3
    box = atoms_per_dim * lattice
    cell = np.eye(3) * box
    samples = []
    for _ in range(num_configs):
        grid = np.stack(np.meshgrid(*[np.arange(atoms_per_dim)] * 3,
                                    indexing="ij"), axis=-1).reshape(-1, 3)
        pos = (grid + 0.5) * lattice + rng.randn(n, 3) * jitter
        pos = pos % box
        energy, forces, (send, recv, shifts) = lj_energy_forces(
            pos, cell, cutoff)
        samples.append(GraphSample(
            x=np.ones((n, 1), np.float32), pos=pos.astype(np.float32),
            senders=send, receivers=recv, edge_shifts=shifts, cell=cell,
            y_node=np.zeros((n, 1), np.float32),
            energy=np.asarray([energy], np.float32),
            forces=forces.astype(np.float32)))
    if normalize:
        es = np.asarray([s.energy[0] for s in samples])
        mean, std = float(es.mean()), float(es.std() + 1e-8)
        for s in samples:
            s.energy = ((s.energy - mean) / std).astype(np.float32)
            s.forces = (s.forces / std).astype(np.float32)
    return samples


def tie_rich_neighbor_case(seed: int = 0, n: int = 24, k: int = 8,
                           f: int = 6, bf16_exact: bool = False):
    """Dyadic inputs of the PNA aggregation on the dense layout on which
    every gradient is exact in float32: (proj_i, proj_j [n, f], nbr [n, k]
    int32, mask [n, k] bool). Each row's real slots are 0, 1, 2, 4 or 8
    (counts that divide exactly), neighbours taken in pairs (two tied
    messages), and one row holds one neighbour in all 8 slots (8 ties, a
    variance of exactly 0); proj_j differs between any two rows, so ties
    come only from repeated neighbours. Masked slots point at real rows.
    Values are multiples of 1/1024 below 1 in magnitude, so their squares
    and sums are exact too.

    `bf16_exact` draws proj_j from multiples of 1/8 in [-2, 2) instead
    (ties then also come from equal values): every message is a multiple
    of 1/16 below 2.5 in magnitude, exact in bf16, its bf16-rounded square
    a multiple of 1/256, and float32 sums of up to 256 of them are exact
    in any order, so the bf16 kernels and their plain versions agree bit
    for bit."""
    rng = np.random.RandomState(seed)
    proj_i = rng.randint(-8, 8, (n, f)).astype(np.float32) / 16
    if bf16_exact:
        proj_j = rng.randint(-16, 16, (n, f)).astype(np.float32) / 8
    else:
        proj_j = (np.arange(n, dtype=np.float32)[:, None] / 64
                  + rng.randint(0, 4, (1, f)).astype(np.float32) / 1024)
    nbr = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = np.zeros((n, k), bool)
    for row in range(n):
        real = (0, 1, 2, 4, 8)[row % 5] if row != 3 else 8
        picks = rng.choice(n, max(real // 2, 1), replace=False)
        slots = (np.repeat(picks, 2) if real > 1 else picks)[:real]
        if row == 3:
            slots = np.full(8, picks[0])
        nbr[row, :real] = slots
        mask[row, :real] = True
    return proj_i, proj_j, nbr, mask


def tie_rich_edge_case(seed: int = 0, n: int = 24, f: int = 6,
                       bf16_exact: bool = False):
    """The edge-list counterpart of `tie_rich_neighbor_case`: (proj_i,
    proj_j, senders, receivers int32, edge_mask bool) whose kept in-edges
    per node are 0, 1, 2, 4 or 8, senders in pairs, plus masked edges into
    every node and edges whose receiver lies outside [0, n)."""
    proj_i, proj_j, nbr, mask = tie_rich_neighbor_case(seed, n, 8, f,
                                                       bf16_exact)
    rows = np.repeat(np.arange(n, dtype=np.int32), 8)
    send, recv, keep = nbr.reshape(-1), rows, mask.reshape(-1)
    order = np.random.RandomState(seed + 1).permutation(send.size)
    send, recv, keep = send[order], recv[order].copy(), keep[order]
    recv[~keep & (np.arange(send.size) % 7 == 0)] = n + 2
    return proj_i, proj_j, send, recv, keep
