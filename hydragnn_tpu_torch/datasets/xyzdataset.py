"""XYZ / extended-XYZ raw dataset (counterpart:
hydragnn_tpu/datasets/xyzdataset.py).

A directory of `*.xyz` files, each one structure (plain XYZ, or the
extxyz `Lattice="..."` comment for a cell), node features the atomic
numbers, graph targets from a `<stem>_energy.txt` sidecar's columns
(`Dataset.graph_features`), min-max normalized over the dataset. The
graphs are built serially by preprocess/transforms.build_graph_samples,
as the JAX package's are with no worker pool; the sample cache and the
pool stay refused (preprocess/load_data.check_preprocess_knobs).
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from ..graphs.batch import GraphSample
from ..preprocess.transforms import (build_graph_samples,
                                     normalize_edge_lengths)
from ..utils.elements import symbol_to_z
from .lsmsdataset import normalize_sidecar_graph_targets
from .split import split_dataset


def parse_xyz_file(filepath: str) -> Tuple[np.ndarray, np.ndarray,
                                           Optional[np.ndarray]]:
    """-> (atomic numbers [N, 1] float32, pos [N, 3] float32, cell
    [3, 3] or None)."""
    with open(filepath, encoding="utf-8") as f:
        lines = f.readlines()
    natoms = int(lines[0].split()[0])
    comment = lines[1] if len(lines) > 1 else ""
    cell = None
    m = re.search(r'Lattice\s*=\s*"([^"]+)"', comment)
    if m:
        vals = [float(v) for v in m.group(1).split()]
        cell = np.asarray(vals, np.float32).reshape(3, 3)
    zs, pos = [], []
    for line in lines[2:2 + natoms]:
        tok = line.split()
        sym = tok[0]
        z = int(sym) if sym.isdigit() else symbol_to_z(sym)
        zs.append(z)
        pos.append([float(tok[1]), float(tok[2]), float(tok[3])])
    return (np.asarray(zs, np.float32)[:, None],
            np.asarray(pos, np.float32), cell)


def _read_sidecar_graph_feats(filepath: str, graph_feature_dims,
                              graph_feature_cols) -> Optional[np.ndarray]:
    """Graph targets from the first line of a `<stem>_energy.txt` (XYZ)
    or `<stem>.bulk` (CFG) sidecar; None when the file is absent."""
    if not os.path.exists(filepath):
        return None
    with open(filepath, encoding="utf-8") as f:
        tok = f.readline().split()
    feats = []
    for item, dim in enumerate(graph_feature_dims):
        for icomp in range(dim):
            feats.append(float(tok[graph_feature_cols[item] + icomp]))
    return np.asarray(feats, np.float32)


class XYZDataset:
    """A directory of `*.xyz` files (and `*_energy.txt` graph-target
    sidecars) -> GraphSamples."""

    def __init__(self, config: Dict, dirpath: str):
        ds = config["Dataset"]
        gf = ds.get("graph_features", {"dim": [], "column_index": []})
        files = sorted(glob.glob(os.path.join(dirpath, "*.xyz")))
        if not files:
            raise FileNotFoundError(f"no .xyz files in {dirpath}")
        needs_graph_target = "graph" in config["NeuralNetwork"][
            "Variables_of_interest"]["type"]
        parsed = [parse_xyz_file(fp) for fp in files]
        gfeat_all = [_read_sidecar_graph_feats(
            os.path.splitext(fp)[0] + "_energy.txt", gf["dim"],
            gf["column_index"]) for fp in files]
        # node features are bare atomic numbers, left unscaled
        gfeat_all, mm_graph = normalize_sidecar_graph_targets(
            gfeat_all, gf["dim"], needs_graph_target, "*_energy.txt",
            dirpath)
        self.samples = build_graph_samples(
            [dict(node_feature_matrix=z, pos=pos, graph_feats=gfeat,
                  cell=cell)
             for (z, pos, cell), gfeat in zip(parsed, gfeat_all)], config)
        normalize_edge_lengths(self.samples)
        self.minmax_node_feature = None
        self.minmax_graph_feature = mm_graph

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i) -> GraphSample:
        return self.samples[i]

    def __iter__(self):
        return iter(self.samples)


def load_xyz_splits(config: Dict):
    """(train, val, test) of `Dataset.path.total`, split by
    `perc_train`, as plain lists (as the JAX package returns them)."""
    ds = config["Dataset"]
    total = XYZDataset(config, ds["path"]["total"])
    perc = config["NeuralNetwork"]["Training"].get("perc_train", 0.7)
    return split_dataset(list(total), perc,
                         ds.get("compositional_stratified_splitting", False))
