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

`oc20_slabs` and `qm9_molecules` are the synthetic data of the OC20 and
QM9 examples, bitwise: examples/open_catalyst_2020/oc20_data.py's
`generate_oc20_dataset` frames (as generated, before the example writes
them as extxyz text) through examples/common_atomistic.py's
`frame_to_sample` (datasets/atomistic.py), and examples/qm9/qm9_data.py's
`_synthetic_qm9` molecules as `load_qm9` makes them samples.

`generate_oc20_dataset`, `generate_oc22_dataset`, `generate_csce_csv`
and `generate_ogb_csv` write the files of the OC20, OC22, csce and ogb
examples (examples/open_catalyst_2020/oc20_data.py,
examples/open_catalyst_2022/oc22_data.py, examples/csce/csce_data.py,
examples/ogb/ogb_data.py) byte for byte for the same seed: extxyz chunks
and trajectories that datasets/atomistic.py reads, and SMILES CSVs that
datasets/smiles.py featurizes.

`bcc_lattices` is the deterministic BCC lattice data of the model zoo's
threshold rows (tests/deterministic_data.py
`deterministic_graph_dataset`), bitwise, so `chip_smoke.py` trains those
rows without the test suite or the JAX package.

`ninb_cfg_files` and `fept_lsms_files` write the raw files of the eam and
lsms examples (examples/eam/eam_data.py `generate_ninb_dataset`,
examples/lsms/lsms_data.py `generate_fept_dataset`) byte for byte, so the
port reads the examples' configs from its own files on a machine without
the JAX package: FCC NiNb cells with per-atom EAM energies (and forces,
and `.bulk` bulk moduli) as AtomEye CFG files, and BCC FePt cells as LSMS
text files.

`build_members` and `split_members` are the GFM mixture example's member
datasets (examples/gfm/gfm_data.py), bitwise: three BCC-lattice members,
"alpha", "beta" and "gamma" (`MEMBER_SPECS`), each with its own
polynomial graph target in its own column of the union label layout.

`OgbnGraph`, `synthetic_arxiv` and `load_ogbn` are the ogbn example's
node-classification graph (examples/ogbn/ogbn_data.py), bitwise: a
homophilous synthetic citation graph with an id-range split, or the
example's ``ogbn_graph.npz`` where one is given.
"""
from __future__ import annotations

import csv
import dataclasses
import hashlib
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..datasets.atomistic import OC22_TRAJ_SUBDIR, frame_to_sample
from ..datasets.extxyz import Frame, write_extxyz
from ..utils.elements import SYMBOLS
from .batch import GraphSample
from .radius import radius_graph, radius_graph_pbc


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


# the NiNb EAM model: species, masses, embedding strengths and the pair
# term of examples/eam/eam_data.py
Z_NI, Z_NB = 28.0, 41.0
NINB_MASS = {Z_NI: 58.69, Z_NB: 92.91}
NINB_A_EMB = {Z_NI: 1.8, Z_NB: 2.4}
NINB_B_PAIR = 0.8
NINB_R0 = 2.6


def eam_energy_forces(pos: np.ndarray, cell: np.ndarray, z: np.ndarray,
                      cutoff: float = 5.0):
    """Per-atom EAM energies and analytic forces under periodic
    boundaries: embedding -A sqrt(rho), rho_i = sum_j exp(-r_ij / r0),
    pair B exp(-2 r / r0)."""
    send, recv, shifts = radius_graph_pbc(pos, cell, cutoff)
    disp = pos[send] + shifts - pos[recv]
    r = np.maximum(np.linalg.norm(disp, axis=1), 1e-9)
    w = np.exp(-r / NINB_R0)
    n = len(pos)
    rho = np.zeros(n)
    np.add.at(rho, recv, w)
    rho = np.maximum(rho, 1e-12)
    a = np.vectorize(NINB_A_EMB.get)(z)
    e_emb = -a * np.sqrt(rho)
    pair = NINB_B_PAIR * np.exp(-2.0 * r / NINB_R0)
    e_pair = np.zeros(n)
    np.add.at(e_pair, recv, 0.5 * pair)
    e_atom = e_emb + e_pair
    demb = (a[recv] / (2.0 * np.sqrt(rho[recv])) +
            a[send] / (2.0 * np.sqrt(rho[send]))) * (w / NINB_R0)
    dEdr = demb - 2.0 * pair / NINB_R0
    f_edge = dEdr[:, None] * disp / r[:, None]   # disp = x_send - x_recv
    forces = np.zeros_like(pos)
    np.add.at(forces, recv, f_edge)
    return e_atom, forces


def ninb_bulk_modulus(c_nb: float) -> float:
    """The bulk modulus stand-in: Ni 180 -> Nb 170 with a solid-solution
    bump."""
    return 180.0 - 10.0 * c_nb + 25.0 * c_nb * (1.0 - c_nb)


def _write_cfg(path: str, pos_frac: np.ndarray, cell: np.ndarray,
               z: np.ndarray, e_atom: np.ndarray, forces: np.ndarray,
               with_forces: bool):
    naux = 4 if with_forces else 1
    lines = [f"Number of particles = {len(z)}",
             "A = 1.0 Angstrom (basic length-scale)"]
    for i in range(3):
        for j in range(3):
            lines.append(f"H0({i+1},{j+1}) = {cell[i,j]:.6f} A")
    lines.append(".NO_VELOCITY.")
    lines.append(f"entry_count = {3 + naux}")
    lines.append("auxiliary[0] = c_peratom [eV]")
    if with_forces:
        for k, name in enumerate(("fx", "fy", "fz")):
            lines.append(f"auxiliary[{k+1}] = {name} [eV/A]")
    for i in range(len(z)):
        lines.append(f"{NINB_MASS[float(z[i])]:.4f}")
        lines.append(SYMBOLS[int(z[i])])
        row = list(pos_frac[i]) + [e_atom[i]]
        if with_forces:
            row += list(forces[i])
        lines.append(" ".join(f"{v:.8f}" for v in row))
    with open(path, "w") as f:
        f.write("\n".join(lines))


def ninb_cfg_files(dirpath: str, num_configs: int = 100,
                   cells_per_dim: int = 2, lattice: float = 3.52,
                   jitter: float = 0.06, with_forces: bool = False,
                   with_bulk: bool = False, seed: int = 0) -> str:
    """Write `num_configs` FCC Ni(1-c)Nb(c) supercells (4 atoms a cell,
    cells_per_dim^3 cells) as `NiNb_{i:05d}.cfg` under `dirpath`, with
    `.bulk` sidecars when `with_bulk`; returns `dirpath`."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.RandomState(seed)
    basis = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    grid = np.stack(np.meshgrid(*[np.arange(cells_per_dim)] * 3,
                                indexing="ij"), axis=-1).reshape(-1, 3)
    frac = ((grid[:, None, :] + basis[None]) / cells_per_dim).reshape(-1, 3)
    box = cells_per_dim * lattice
    cell = np.eye(3) * box
    n = len(frac)
    for i in range(num_configs):
        c_nb = rng.uniform(0.05, 0.5)
        z = np.where(rng.rand(n) < c_nb, Z_NB, Z_NI)
        pos = (frac * box + rng.randn(n, 3) * jitter) % box
        e_atom, forces = eam_energy_forces(pos, cell, z)
        stem = os.path.join(dirpath, f"NiNb_{i:05d}")
        _write_cfg(stem + ".cfg", pos / box, cell, z, e_atom, forces,
                   with_forces)
        if with_bulk:
            b = ninb_bulk_modulus(float((z == Z_NB).mean()))
            with open(stem + ".bulk", "w") as f:
                f.write(f"0.0 0.0 {b:.6f}\n")
    return dirpath


Z_FE, Z_PT = 26.0, 78.0


def fept_lsms_files(dirpath: str, num_configs: int = 200,
                    atoms_per_dim: int = 2, lattice: float = 2.85,
                    jitter: float = 0.05, seed: int = 0) -> str:
    """Write `num_configs` BCC FePt cells (2 * atoms_per_dim^3 atoms) as
    LSMS text files `FePt_{i:05d}.txt` under `dirpath`: line 0 the
    mixing-enthalpy-shaped free energy, then per atom [Z, 0, x, y, z,
    charge density + Z, magnetic moment]; returns `dirpath`."""
    os.makedirs(dirpath, exist_ok=True)
    rng = np.random.RandomState(seed)
    grid = np.stack(np.meshgrid(*[np.arange(atoms_per_dim)] * 3,
                                indexing="ij"), axis=-1).reshape(-1, 3)
    corners = grid * lattice
    centers = corners + lattice / 2.0
    base = np.concatenate([corners, centers]).astype(np.float64)
    n = len(base)
    for i in range(num_configs):
        z = np.where(rng.rand(n) < rng.uniform(0.2, 0.8), Z_FE, Z_PT)
        c_fe = float((z == Z_FE).mean())
        pos = base + rng.randn(n, 3) * jitter
        fe = -4.0 * c_fe * (1.0 - c_fe) + 0.05 * np.sin(6.0 * np.pi * c_fe)
        fe = fe * n + rng.randn() * 0.01
        charge = np.where(z == Z_FE, -0.3 * (1 - c_fe), 0.3 * c_fe)
        charge += rng.randn(n) * 0.01
        moment = np.where(z == Z_FE, 2.2 + 0.5 * (1 - c_fe), 0.3 * c_fe)
        moment += rng.randn(n) * 0.01
        lines = [f"{fe:.8f} 0.0"]
        for a in range(n):
            lines.append(
                f"{z[a]:.1f} 0 {pos[a,0]:.6f} {pos[a,1]:.6f} {pos[a,2]:.6f} "
                f"{charge[a] + z[a]:.6f} {moment[a]:.6f}")
        with open(os.path.join(dirpath, f"FePt_{i:05d}.txt"), "w") as f:
            f.write("\n".join(lines))
    return dirpath


def oc20_slabs(num: int, seed: int = 0, radius: float = 5.0,
               max_neighbours: int = 512) -> List[GraphSample]:
    """OC20-style frames: a 3 x 3 x 3 Cu or Pt fcc slab with a CO
    adsorbate above a random top-layer site (29 atoms) in a 10.8 x 10.8
    x 25 A periodic cell, displaced by N(0, 0.08 A) from the ideal sites,
    with a harmonic-well energy and forces. The OC20 example trains on
    them with radius 5 and max_neighbours min(config, 512)."""
    rng = np.random.RandomState(seed)
    a = 3.6
    nx = ny = 3
    layers = 3
    out = []
    for _ in range(num):
        metal = 29.0 if rng.rand() < 0.5 else 78.0
        slab_pos, slab_z = [], []
        for layer in range(layers):
            for i in range(nx):
                for j in range(ny):
                    off = (a / 2 if layer % 2 else 0.0)
                    slab_pos.append([i * a + off, j * a + off,
                                     layer * a * 0.7])
                    slab_z.append(metal)
        site = rng.randint(len(slab_pos) - nx * ny, len(slab_pos))
        cx, cy, cz = slab_pos[site]
        slab_pos += [[cx, cy, cz + 1.9], [cx, cy, cz + 3.05]]
        slab_z += [6.0, 8.0]
        pos0 = np.asarray(slab_pos, np.float32)
        z = np.asarray(slab_z, np.float32)
        disp = rng.randn(*pos0.shape).astype(np.float32) * 0.08
        pos = pos0 + disp
        k = 5.0
        energy = (-3.0 * len(z) + 0.5 * k * float((disp ** 2).sum())
                  - 1.5 * (metal == 78.0))
        forces = (-k * disp).astype(np.float32)
        cell = np.diag([nx * a, ny * a, 25.0]).astype(np.float32)
        sample = frame_to_sample(z, pos, energy, forces, radius,
                                 max_neighbours, cell=cell)
        if sample is not None:
            out.append(sample)
    return out


def qm9_molecules(num: int, seed: int = 0, radius: float = 7.0,
                  max_neighbours: int = 5) -> List[GraphSample]:
    """QM9-style CHNOF molecules: a random tree of 4-9 heavy atoms with
    ~1.4 A bonds and 2-7 hydrogens at 1 A, x = Z, target the free
    energy per atom of a closed form of composition and geometry, edges
    within `radius` capped at `max_neighbours` per atom."""
    rng = np.random.RandomState(seed)
    elements = np.array([6, 7, 8, 9], np.float32)          # C N O F
    elem_term = {1.0: -0.5, 6.0: -38.0, 7.0: -54.6, 8.0: -75.2, 9.0: -99.8}
    out = []
    for _ in range(num):
        n_heavy = rng.randint(4, 10)
        zs = [float(rng.choice(elements)) for _ in range(n_heavy)]
        pos = [np.zeros(3)]
        for i in range(1, n_heavy):
            parent = rng.randint(0, i)
            direction = rng.randn(3)
            direction /= np.linalg.norm(direction) + 1e-9
            pos.append(pos[parent] + direction * (1.4 + 0.1 * rng.randn()))
        n_h = rng.randint(2, 8)
        for _ in range(n_h):
            parent = rng.randint(0, n_heavy)
            direction = rng.randn(3)
            direction /= np.linalg.norm(direction) + 1e-9
            zs.append(1.0)
            pos.append(pos[parent] + direction * 1.0)
        zs = np.asarray(zs, np.float32)
        pos = np.asarray(pos, np.float32)
        g = sum(elem_term[z] for z in zs)
        d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
        g += 0.1 * float(np.exp(-d[d > 0]).sum())
        g = np.float32(g)
        send, recv = radius_graph(pos, radius, max_neighbours=max_neighbours)
        out.append(GraphSample(x=zs[:, None], pos=pos, senders=send,
                               receivers=recv,
                               y_graph=np.asarray([g / len(zs)], np.float32)))
    return out


def bcc_positions(uc_x: int, uc_y: int, uc_z: int) -> np.ndarray:
    """The atoms of a uc_x x uc_y x uc_z body-centred cubic supercell."""
    pos = []
    for x in range(uc_x):
        for y in range(uc_y):
            for z in range(uc_z):
                pos.append([x, y, z])
                pos.append([x + 0.5, y + 0.5, z + 0.5])
    return np.asarray(pos, dtype=np.float32)


def bcc_lattices(num_configs: int = 200, num_types: int = 3,
                 radius: float = 1.0, max_neighbours: int = 100,
                 seed: int = 0, heads=("graph",)) -> List[GraphSample]:
    """BCC supercells of 1-3 x 1-3 x 1-2 unit cells with one node feature
    x = (node id mod num_types + 1) / num_types and closed-form targets:
    with a "graph" head y_graph = sum(x) + sum(x²) + sum(x³), min-max
    normalized to [0, 1] over the dataset; one column x^(k+1) of y_node
    for the k-th "node" head."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(num_configs):
        ucx = rng.randint(1, 4)
        ucy = rng.randint(1, 4)
        ucz = rng.randint(1, 3)
        pos = bcc_positions(ucx, ucy, ucz)
        n = pos.shape[0]
        types = np.arange(n) % num_types
        x = (types.astype(np.float32) + 1.0) / num_types
        send, recv = radius_graph(pos, radius, max_neighbours)
        y_graph = y_node = None
        if "graph" in heads:
            y_graph = np.asarray([x.sum() + (x ** 2).sum() + (x ** 3).sum()],
                                 np.float32)
        n_node_heads = sum(1 for h in heads if h == "node")
        if n_node_heads:
            y_node = np.stack([x ** (k + 1) for k in range(n_node_heads)],
                              axis=1).astype(np.float32)
        samples.append(GraphSample(x=x[:, None], pos=pos, senders=send,
                                   receivers=recv, y_graph=y_graph,
                                   y_node=y_node))
    if "graph" in heads:
        ys = np.stack([s.y_graph for s in samples])
        lo, hi = ys.min(0), ys.max(0)
        span = np.maximum(hi - lo, 1e-8)
        for s in samples:
            s.y_graph = ((s.y_graph - lo) / span).astype(np.float32)
    return samples


def mark_synthetic(dirpath: str) -> None:
    """The `.synthetic` marker the examples' generators leave in their
    output directory (examples/common_atomistic.py `mark_synthetic`)."""
    os.makedirs(dirpath, exist_ok=True)
    with open(os.path.join(dirpath, ".synthetic"), "w") as f:
        f.write("generated stand-in data; safe to delete\n")


def generate_oc20_dataset(dirpath: str, num_chunks: int = 2,
                          frames_per_chunk: int = 40, seed: int = 0) -> str:
    """The OC20 example's chunks, byte for byte
    (examples/open_catalyst_2020/oc20_data.py): Cu or Pt slab + CO
    frames with harmonic-well energies and forces as
    `<dirpath>/synthetic/<chunk>.extxyz`; returns that directory."""
    dirpath = os.path.join(dirpath, "synthetic")
    mark_synthetic(dirpath)
    rng = np.random.RandomState(seed)
    a = 3.6
    nx = ny = 3
    layers = 3
    for chunk in range(num_chunks):
        frames = []
        for _ in range(frames_per_chunk):
            metal = 29.0 if rng.rand() < 0.5 else 78.0
            slab_pos, slab_z = [], []
            for layer in range(layers):
                for i in range(nx):
                    for j in range(ny):
                        off = (a / 2 if layer % 2 else 0.0)
                        slab_pos.append([i * a + off, j * a + off,
                                         layer * a * 0.7])
                        slab_z.append(metal)
            site = rng.randint(len(slab_pos) - nx * ny, len(slab_pos))
            cx, cy, cz = slab_pos[site]
            slab_pos += [[cx, cy, cz + 1.9], [cx, cy, cz + 3.05]]
            slab_z += [6.0, 8.0]
            pos0 = np.asarray(slab_pos, np.float32)
            z = np.asarray(slab_z, np.float32)
            disp = rng.randn(*pos0.shape).astype(np.float32) * 0.08
            pos = pos0 + disp
            k = 5.0
            energy = (-3.0 * len(z) + 0.5 * k * float((disp ** 2).sum())
                      - 1.5 * (metal == 78.0))
            forces = (-k * disp).astype(np.float32)
            cell = np.diag([nx * a, ny * a, 25.0]).astype(np.float32)
            frames.append(Frame(z, pos, cell, {"forces": forces},
                                {"energy": energy, "free_energy": energy}))
        write_extxyz(os.path.join(dirpath, f"{chunk}.extxyz"), frames)
    return dirpath


def generate_oc22_dataset(dirpath: str, data_type: str = "train",
                          num_systems: int = 8, frames_per_system: int = 10,
                          seed: int = 0) -> str:
    """The OC22 example's trajectories, byte for byte
    (examples/open_catalyst_2022/oc22_data.py): Ti or Ir oxide slabs
    with harmonic-well energies and forces, one extxyz file a system
    under `<dirpath>/synthetic/oc22_trajectories/trajectories/oc22/
    <data_type>/` and the `<data_type>_t.txt` list beside it; returns
    `<dirpath>/synthetic`."""
    base = os.path.join(dirpath, "synthetic")
    mark_synthetic(base)
    root = os.path.join(base, OC22_TRAJ_SUBDIR)
    os.makedirs(os.path.join(root, data_type), exist_ok=True)
    rng = np.random.RandomState(seed)
    a = 3.2
    names = []
    for sysid in range(num_systems):
        metal = 22.0 if rng.rand() < 0.5 else 77.0
        pos0, z = [], []
        for layer in range(2):
            for i in range(3):
                for j in range(3):
                    pos0.append([i * a, j * a, layer * a * 0.8])
                    z.append(metal)
                    pos0.append([i * a + a / 2, j * a + a / 2,
                                 layer * a * 0.8 + a * 0.4])
                    z.append(8.0)
        pos0 = np.asarray(pos0, np.float32)
        z = np.asarray(z, np.float32)
        cell = np.diag([3 * a, 3 * a, 20.0]).astype(np.float32)
        frames = []
        for _ in range(frames_per_system):
            disp = rng.randn(*pos0.shape).astype(np.float32) * 0.07
            pos = pos0 + disp
            k = 6.0
            energy = -4.0 * len(z) + 0.5 * k * float((disp ** 2).sum())
            forces = (-k * disp).astype(np.float32)
            frames.append(Frame(z, pos, cell, {"forces": forces},
                                {"energy": energy}))
        name = f"sys_{sysid:04d}.extxyz"
        write_extxyz(os.path.join(root, data_type, name), frames)
        names.append(name)
    with open(os.path.join(root, f"{data_type}_t.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return base


def random_smiles(rng) -> Tuple[str, float]:
    """A random organic molecule of 2-6 fragments and its closed-form
    gap label (examples/csce/csce_data.py `random_smiles`)."""
    frags = ["C", "C", "C", "N", "O", "S", "F", "C=C", "C#N", "C(=O)O",
             "c1ccccc1", "C(N)=O"]
    n = rng.randint(2, 6)
    smi = "".join(frags[rng.randint(len(frags))] for _ in range(n))
    n_c = smi.count("C") + smi.count("c")
    n_o = smi.count("O")
    n_n = smi.count("N") + smi.count("n")
    n_arom = smi.count("c1")
    gap = (7.5 - 0.25 * n_c - 0.4 * n_arom + 0.15 * n_o - 0.1 * n_n
           + 0.05 * np.sin(3.0 * n_c + n_o))
    return smi, float(gap)


def generate_csce_csv(dirpath: str, num_mols: int = 300, seed: int = 0
                      ) -> str:
    """The csce example's CSV, byte for byte (examples/csce/csce_data.py):
    `id,smiles,gap,extra` rows at `<dirpath>/synthetic/
    csce_gap_synth.csv`; returns its path."""
    dirpath = os.path.join(dirpath, "synthetic")
    mark_synthetic(dirpath)
    path = os.path.join(dirpath, "csce_gap_synth.csv")
    rng = np.random.RandomState(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "smiles", "gap", "extra"])
        for i in range(num_mols):
            smi, gap = random_smiles(rng)
            w.writerow([i, smi, f"{gap:.6f}", 0])
    return path


def generate_ogb_csv(dirpath: str, num_mols: int = 300, seed: int = 0
                     ) -> str:
    """The ogb example's CSV, byte for byte (examples/ogb/ogb_data.py):
    `smiles,gap` rows at `<dirpath>/synthetic/pcqm4m_gap_synth.csv`;
    returns `<dirpath>/synthetic`."""
    dirpath = os.path.join(dirpath, "synthetic")
    mark_synthetic(dirpath)
    rng = np.random.RandomState(seed)
    path = os.path.join(dirpath, "pcqm4m_gap_synth.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", "gap"])
        for _ in range(num_mols):
            smi, gap = random_smiles(rng)
            w.writerow([smi, f"{gap:.6f}"])
    return dirpath


# member name -> coefficients (a, b, c) of its graph target
# sum_n(a x + b x^2 + c x^3); alphabetical, as the mixture loader sorts
# its members: column i, head i and dataset_id i are one member
MEMBER_SPECS: Tuple[Tuple[str, Tuple[float, float, float]], ...] = (
    ("alpha", (1.0, 1.0, 1.0)),
    ("beta", (2.0, -1.0, 0.0)),
    ("gamma", (0.0, 1.0, -2.0)),
)


def _gfm_member(num_configs: int, coeffs: Tuple[float, float, float],
                column: int, num_columns: int, seed: int,
                dyadic: bool = False) -> List[GraphSample]:
    """One member: random BCC supercells, x = (type + 1) / 3, the graph
    target min-max normalized over the member, in union column `column`
    (the others 0). `dyadic` rounds x and the targets to multiples of
    2^-6, exact in float32."""
    rng = np.random.RandomState(int(seed))
    a, b, c = coeffs
    graphs, targets = [], []
    for _ in range(int(num_configs)):
        ucx, ucy = rng.randint(1, 4), rng.randint(1, 4)
        ucz = rng.randint(1, 3)
        pos = []
        for ix in range(ucx):
            for iy in range(ucy):
                for iz in range(ucz):
                    pos.append([ix, iy, iz])
                    pos.append([ix + 0.5, iy + 0.5, iz + 0.5])
        pos = np.asarray(pos, dtype=np.float32)
        types = np.arange(pos.shape[0]) % 3
        x = (types.astype(np.float32) + 1.0) / 3.0
        if dyadic:
            x = np.round(x * 64.0) / 64.0
        send, recv = radius_graph(pos, 1.0, 100)
        graphs.append((x, pos, send, recv))
        targets.append(float((a * x + b * x ** 2 + c * x ** 3).sum()))
    t = np.asarray(targets, np.float64)
    lo, hi = float(t.min()), float(t.max())
    t = (t - lo) / max(hi - lo, 1e-12)
    if dyadic:
        t = np.round(t * 64.0) / 64.0
    samples = []
    for (x, pos, send, recv), target in zip(graphs, t):
        y = np.zeros(num_columns, np.float32)
        y[column] = target
        samples.append(GraphSample(
            x=x[:, None], pos=pos, senders=send, receivers=recv,
            y_graph=y))
    return samples


def build_members(sizes: Optional[Sequence[int]] = None, seed: int = 0,
                  dyadic: bool = False) -> Dict[str, List[GraphSample]]:
    """The GFM example's members, name -> samples: `sizes` in
    MEMBER_SPECS order (default 48/32/40), member i seeded seed + 100 (i
    + 1)."""
    if sizes is None:
        sizes = (48, 32, 40)
    if len(sizes) != len(MEMBER_SPECS):
        raise ValueError(
            f"got {len(sizes)} sizes for {len(MEMBER_SPECS)} members")
    members = {}
    for i, (name, coeffs) in enumerate(MEMBER_SPECS):
        members[name] = _gfm_member(
            int(sizes[i]), coeffs, i, len(MEMBER_SPECS),
            seed=int(seed) + 100 * (i + 1), dyadic=dyadic)
    return members


def split_members(members: Dict[str, List[GraphSample]],
                  val_frac: float = 0.2
                  ) -> Tuple[Dict[str, List[GraphSample]],
                             Dict[str, List[GraphSample]]]:
    """(train, val): each member's last ceil(val_frac n) samples (at
    least one) are its validation samples."""
    train, val = {}, {}
    for name, samples in members.items():
        k = max(int(np.ceil(len(samples) * float(val_frac))), 1)
        train[name] = samples[:-k]
        val[name] = samples[-k:]
    return train, val


# ----------------------------------------------------------- ogbn graph --
@dataclasses.dataclass
class OgbnGraph:
    """One node-classification graph and its split: the sampled loader's
    input. ``y_onehot`` is what the "ce" loss takes."""
    x: np.ndarray            # [N, F] float32
    label: np.ndarray        # [N] int32
    senders: np.ndarray      # [E] int64
    receivers: np.ndarray    # [E] int64
    train_idx: np.ndarray    # int64 node ids
    val_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def y_onehot(self) -> np.ndarray:
        return np.eye(self.num_classes, dtype=np.float32)[self.label]

    def fingerprint(self) -> str:
        """Content hash for the feature store's cache key
        (preprocess/cache.feature_store_key)."""
        h = hashlib.sha256()
        for arr in (self.x, self.label, self.senders, self.receivers,
                    self.train_idx, self.val_idx, self.test_idx):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()[:32]


def synthetic_arxiv(num_nodes: int = 2000, feat_dim: int = 16,
                    num_classes: int = 8, avg_degree: int = 6,
                    homophily: float = 0.65, seed: int = 0) -> OgbnGraph:
    """A homophilous synthetic citation graph: features are a class
    centroid plus noise, and each paper cites about `avg_degree` earlier
    ones, of its own class with probability `homophily`; edges are
    symmetrized; the split is by id range (60 / 20 / 20 %)."""
    rng = np.random.RandomState(int(seed))
    label = rng.randint(0, num_classes, num_nodes).astype(np.int32)
    centroids = rng.randn(num_classes, feat_dim).astype(np.float32)
    x = (centroids[label]
         + 0.8 * rng.randn(num_nodes, feat_dim)).astype(np.float32)

    by_class = [np.flatnonzero(label == c) for c in range(num_classes)]
    senders, receivers = [], []
    for v in range(1, num_nodes):
        d = max(int(rng.poisson(avg_degree)), 1)
        pool = by_class[label[v]]
        pool = pool[pool < v]
        for _ in range(d):
            if pool.size and rng.rand() < homophily:
                u = int(pool[rng.randint(pool.size)])
            else:
                u = int(rng.randint(v))
            senders.extend((v, u))
            receivers.extend((u, v))
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)

    n_train = int(num_nodes * 0.6)
    n_val = int(num_nodes * 0.2)
    ids = np.arange(num_nodes, dtype=np.int64)
    return OgbnGraph(
        x=x, label=label, senders=senders, receivers=receivers,
        train_idx=ids[:n_train], val_idx=ids[n_train:n_train + n_val],
        test_idx=ids[n_train + n_val:], num_classes=int(num_classes))


OGBN_NPZ_NAME = "ogbn_graph.npz"


def load_ogbn(data_dir: Optional[str] = None, **synth_kw) -> OgbnGraph:
    """The graph of ``<data_dir>/ogbn_graph.npz`` where it exists (keys
    x, label, senders, receivers, train_idx, val_idx, test_idx), else
    `synthetic_arxiv(**synth_kw)`."""
    if data_dir:
        path = os.path.join(data_dir, OGBN_NPZ_NAME)
        if os.path.exists(path):
            z = np.load(path)
            label = np.asarray(z["label"], np.int32).reshape(-1)
            return OgbnGraph(
                x=np.asarray(z["x"], np.float32),
                label=label,
                senders=np.asarray(z["senders"], np.int64),
                receivers=np.asarray(z["receivers"], np.int64),
                train_idx=np.asarray(z["train_idx"], np.int64),
                val_idx=np.asarray(z["val_idx"], np.int64),
                test_idx=np.asarray(z["test_idx"], np.int64),
                num_classes=int(label.max()) + 1)
    return synthetic_arxiv(**synth_kw)
