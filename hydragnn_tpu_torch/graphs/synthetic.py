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
`frame_to_sample`, and examples/qm9/qm9_data.py's `_synthetic_qm9`
molecules as `load_qm9` makes them samples.

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
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

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


FORCES_NORM_THRESHOLD = 100.0


def atomistic_sample(z, pos, energy: float, forces, radius: float,
                     max_neighbours: int, cell=None,
                     energy_per_atom: bool = True):
    """The atomistic examples' sample of one frame
    (examples/common_atomistic.py `frame_to_sample`): x = [Z, pos,
    forces], the radius graph (periodic where the cell is not 0), edge
    lengths as `edge_attr`, the (per-atom) energy as the graph target and
    the forces as the node target; None when a force's norm reaches
    FORCES_NORM_THRESHOLD."""
    forces = np.asarray(forces, np.float32)
    if not np.all(np.linalg.norm(forces, axis=1) < FORCES_NORM_THRESHOLD):
        return None
    z = np.asarray(z, np.float32)
    pos = np.asarray(pos, np.float32)
    x = np.concatenate([z[:, None], pos, forces], axis=1)
    shifts = None
    if cell is not None and np.abs(cell).sum() > 0:
        send, recv, shifts = radius_graph_pbc(pos, cell, radius,
                                              max_neighbours=max_neighbours)
    else:
        send, recv = radius_graph(pos, radius, max_neighbours=max_neighbours)
    vec = pos[send] - pos[recv]
    if shifts is not None:
        vec = vec + shifts
    edge_len = np.linalg.norm(vec, axis=1, keepdims=True).astype(np.float32)
    e = float(energy) / len(z) if energy_per_atom else float(energy)
    return GraphSample(x=x, pos=pos, senders=send, receivers=recv,
                       edge_attr=edge_len, edge_shifts=shifts,
                       y_graph=np.asarray([e], np.float32), y_node=forces,
                       cell=cell, energy=np.asarray([e], np.float32),
                       forces=forces)


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
        sample = atomistic_sample(z, pos, energy, forces, radius,
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
