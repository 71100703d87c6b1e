"""CFG (AtomEye) raw dataset (counterpart:
hydragnn_tpu/datasets/cfgdataset.py).

The standard AtomEye layout: `Number of particles`, the `H0(i,j)` cell
rows, `entry_count`, the `auxiliary[k]` names, then per atom a mass line,
a symbol line and a line of scaled coordinates (plus velocities unless
`.NO_VELOCITY.`) and the auxiliary columns; Cartesian pos = s @ H0. Node
features are [Z, mass, aux...]; a graph target comes from a `<stem>.bulk`
sidecar. Host numpy, bitwise the JAX package's samples.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Tuple

import numpy as np

from ..graphs.batch import GraphSample
from ..preprocess.transforms import (build_graph_samples,
                                     normalize_edge_lengths)
from ..utils.elements import symbol_to_z
from .lsmsdataset import (_minmax_normalize, normalize_sidecar_graph_targets,
                          split_with_minmax)
from .xyzdataset import _read_sidecar_graph_feats


def parse_cfg_file(filepath: str) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """-> (node features [N, 2 + naux], pos [N, 3], cell [3, 3]); feature
    columns [Z, mass, aux...] in the file's auxiliary order."""
    h0 = np.zeros((3, 3), np.float64)
    natoms = None
    entry_count = None
    aux_names = {}
    rows = []
    cur_mass, cur_z = None, None
    has_velocity = True  # until .NO_VELOCITY. (AtomEye's default layout)
    with open(filepath, encoding="utf-8") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if "=" in line and not line[0].isdigit() and not line[0] == "-":
                key, _, val = line.partition("=")
                key, val = key.strip(), val.strip().split()[0]
                if key == "Number of particles":
                    natoms = int(val)
                elif key.startswith("H0("):
                    i, j = int(key[3]), int(key[5])
                    h0[i - 1, j - 1] = float(val)
                elif key == "entry_count":
                    entry_count = int(val)
                elif key.startswith("auxiliary["):
                    aux_names[int(key[10:key.index("]")])] = val
                continue
            if line == ".NO_VELOCITY.":
                has_velocity = False
                continue
            tok = line.split()
            if len(tok) == 1 and natoms is not None:
                if tok[0][0].isdigit():
                    cur_mass = float(tok[0])       # mass line
                else:
                    cur_z = symbol_to_z(tok[0])    # symbol line
                continue
            if len(tok) >= 3 and cur_z is not None:
                vals = [float(t) for t in tok]
                s = np.asarray(vals[:3])
                # velocities (3 columns after the scaled coordinates,
                # unless .NO_VELOCITY.) are not auxiliary features
                aux_start = 6 if has_velocity else 3
                aux = (vals[aux_start:entry_count] if entry_count
                       else vals[aux_start:])
                pos = s @ h0
                rows.append([float(cur_z), float(cur_mass)] + list(pos) + aux)
    if natoms is None or not rows:
        raise ValueError(f"malformed CFG file {filepath}")
    arr = np.asarray(rows, np.float64)
    z_mass = arr[:, :2]
    pos = arr[:, 2:5]
    aux = arr[:, 5:]
    feats = np.concatenate([z_mass, aux], axis=1).astype(np.float32)
    return feats, pos.astype(np.float32), h0.astype(np.float32)


class CFGDataset:
    """A directory of `*.cfg` files (and optional `*.bulk` graph-target
    sidecars) -> GraphSamples."""

    def __init__(self, config: Dict, dirpath: str):
        ds = config["Dataset"]
        gf = ds.get("graph_features", {"dim": [], "column_index": []})
        files = sorted(glob.glob(os.path.join(dirpath, "*.cfg")))
        if not files:
            raise FileNotFoundError(f"no .cfg files in {dirpath}")
        needs_graph_target = "graph" in config["NeuralNetwork"][
            "Variables_of_interest"]["type"]
        parsed = [parse_cfg_file(fp) for fp in files]
        gfeat_all = [_read_sidecar_graph_feats(
            os.path.splitext(fp)[0] + ".bulk", gf["dim"], gf["column_index"])
            for fp in files]
        feats_all, mm_node = _minmax_normalize([p[0] for p in parsed])
        gfeat_all, mm_graph = normalize_sidecar_graph_targets(
            gfeat_all, gf["dim"], needs_graph_target, ".bulk", dirpath)
        self.samples = build_graph_samples(
            [dict(node_feature_matrix=feats, pos=p[1], graph_feats=gfeat,
                  cell=p[2])
             for feats, p, gfeat in zip(feats_all, parsed, gfeat_all)],
            config)
        normalize_edge_lengths(self.samples)
        self.minmax_node_feature = mm_node
        self.minmax_graph_feature = mm_graph

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i) -> GraphSample:
        return self.samples[i]

    def __iter__(self):
        return iter(self.samples)


def load_cfg_splits(config: Dict):
    """(train, val, test) of `Dataset.path.total`, split by `perc_train`;
    the train split carries the reader's min-max."""
    return split_with_minmax(config,
                             CFGDataset(config, config["Dataset"]["path"]
                                        ["total"]))
