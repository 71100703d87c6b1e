"""Atomistic frames -> GraphSamples, and the OC20 / OC22 chunk readers
(counterparts: examples/common_atomistic.py `frame_to_sample`,
examples/open_catalyst_2020/oc20_data.py `load_oc20`,
examples/open_catalyst_2022/oc22_data.py `load_oc22`; the examples
import the JAX package, so the port keeps its own copies, bitwise).

A sample is x = [Z, pos, forces], the radius graph (periodic where the
cell is not 0) with edge lengths as `edge_attr`, the energy (per atom by
default) as the graph target and the forces as the node target; a frame
with a force of norm FORCES_NORM_THRESHOLD or more gives None. Host
numpy only.
"""
from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from ..graphs.batch import GraphSample
from ..graphs.radius import radius_graph, radius_graph_pbc
from .extxyz import iread_extxyz

FORCES_NORM_THRESHOLD = 100.0
OC22_TRAJ_SUBDIR = os.path.join("oc22_trajectories", "trajectories", "oc22")


def frame_to_sample(z, pos, energy: float, forces, radius: float,
                    max_neighbours: int, cell=None,
                    energy_per_atom: bool = True) -> Optional[GraphSample]:
    """One frame's GraphSample; None when a force's norm reaches
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


def _frames_to_samples(paths, energy_keys, radius, max_neighbours, limit,
                       energy_per_atom) -> List[GraphSample]:
    """The samples of every frame of `paths` in order, up to `limit`;
    the energy is the first of `energy_keys` a frame carries (else 0),
    the forces zero where it has none."""
    samples: List[GraphSample] = []
    for path in paths:
        for fr in iread_extxyz(path):
            energy = fr.info.get(energy_keys[0],
                                 fr.info.get(energy_keys[1], 0.0))
            forces = fr.arrays.get(
                "forces", np.zeros((len(fr.z), 3), np.float32))
            s = frame_to_sample(fr.z, fr.pos, energy, forces, radius,
                                max_neighbours, cell=fr.cell,
                                energy_per_atom=energy_per_atom)
            if s is not None:
                samples.append(s)
            if len(samples) >= limit:
                return samples
    return samples


def load_oc20(dirpath: str, radius: float = 5.0, max_neighbours: int = 100,
              limit: int = 1000, energy_per_atom: bool = True
              ) -> List[GraphSample]:
    """The S2EF chunks `dirpath/*.extxyz` (else `dirpath/synthetic/`,
    where graphs.synthetic.generate_oc20_dataset writes them), in file
    order; the energy is `free_energy`, else `energy`."""
    files = sorted(glob.glob(os.path.join(dirpath, "*.extxyz")))
    if not files:
        files = sorted(glob.glob(os.path.join(dirpath, "synthetic",
                                              "*.extxyz")))
    return _frames_to_samples(files, ("free_energy", "energy"), radius,
                              max_neighbours, limit, energy_per_atom)


def load_oc22(dirpath: str, data_type: str = "train", radius: float = 5.0,
              max_neighbours: int = 100, limit: int = 1000,
              energy_per_atom: bool = True) -> List[GraphSample]:
    """The trajectories `<data_type>_t.txt` names under
    `dirpath/oc22_trajectories/trajectories/oc22` (else under
    `dirpath/synthetic/`, where graphs.synthetic.generate_oc22_dataset
    writes them); the energy is `energy`, else `free_energy`."""
    root = os.path.join(dirpath, OC22_TRAJ_SUBDIR)
    if not os.path.exists(os.path.join(root, f"{data_type}_t.txt")):
        root = os.path.join(dirpath, "synthetic", OC22_TRAJ_SUBDIR)
    with open(os.path.join(root, f"{data_type}_t.txt"),
              encoding="utf-8") as f:
        names = [line.strip() for line in f if line.strip()]
    return _frames_to_samples(
        [os.path.join(root, data_type, n) for n in names],
        ("energy", "free_energy"), radius, max_neighbours, limit,
        energy_per_atom)
