"""LSMS text-format raw dataset, also the "unit_test" format (counterpart:
hydragnn_tpu/datasets/lsmsdataset.py).

A file's line 0 holds the graph features; each further line is a node:
its feature columns, with x, y, z in columns 2-4. For the FePt data the
charge-density column is stored minus the proton count. Features are
min-max normalized over the whole dataset, the edges are built by
`preprocess.transforms.build_graph_samples` and the edge lengths
normalized by their global maximum. Host numpy, bitwise the JAX
package's samples.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..graphs.batch import GraphSample
from ..preprocess.transforms import (build_graph_samples,
                                     normalize_edge_lengths)
from .split import split_dataset


class Split(list):
    """A split's samples with its reader's min-max beside them: config
    completion (`config.update_config`) reads `minmax_node_feature` and
    `minmax_graph_feature` off the train split, for `denormalize_output`."""

    def __init__(self, samples, minmax_node_feature=None,
                 minmax_graph_feature=None):
        super().__init__(samples)
        self.minmax_node_feature = minmax_node_feature
        self.minmax_graph_feature = minmax_graph_feature


def parse_lsms_file(filepath: str, node_feature_dims: Sequence[int],
                    node_feature_cols: Sequence[int],
                    graph_feature_dims: Sequence[int],
                    graph_feature_cols: Sequence[int],
                    apply_charge_density: bool = True):
    """One LSMS text file -> (node feature matrix, positions, graph
    features)."""
    with open(filepath, encoding="utf-8") as f:
        lines = f.readlines()
    gtok = lines[0].split()
    g_feature = []
    for item, dim in enumerate(graph_feature_dims):
        for icomp in range(dim):
            g_feature.append(float(gtok[graph_feature_cols[item] + icomp]))
    node_rows, pos_rows = [], []
    for line in lines[1:]:
        tok = line.split()
        if not tok:
            continue
        pos_rows.append([float(tok[2]), float(tok[3]), float(tok[4])])
        feats = []
        for item, dim in enumerate(node_feature_dims):
            for icomp in range(dim):
                feats.append(float(tok[node_feature_cols[item] + icomp]))
        node_rows.append(feats)
    node_feats = np.asarray(node_rows, np.float32)
    pos = np.asarray(pos_rows, np.float32)
    if apply_charge_density and node_feats.shape[1] >= 2:
        # the charge-density column is stored plus the proton count
        node_feats[:, 1] = node_feats[:, 1] - node_feats[:, 0]
    return node_feats, pos, np.asarray(g_feature, np.float32)


def _minmax_normalize(arrs: List[np.ndarray]
                      ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Column-wise min-max over the whole dataset; returns minmax [2, C]."""
    stacked = np.concatenate([a.reshape(-1, a.shape[-1]) for a in arrs],
                             axis=0)
    lo = stacked.min(axis=0)
    hi = stacked.max(axis=0)
    span = np.where(hi - lo > 1e-12, hi - lo, 1.0)
    out = [((a - lo) / span).astype(np.float32) for a in arrs]
    return out, np.stack([lo, hi])


def normalize_sidecar_graph_targets(gfeat_all, gf_dims, needs_graph_target,
                                    what, dirpath):
    """Graph targets read from per-file sidecars (CFG `*.bulk`): all files
    have one or none does, and they are min-max normalized over the
    dataset. Returns (gfeat_all, minmax or None); raises when sidecars are
    partly present, or absent while a graph output is asked for."""
    n_present = sum(g is not None for g in gfeat_all)
    if not gf_dims or n_present == 0:
        if needs_graph_target:
            raise FileNotFoundError(
                f"{dirpath}: graph target requested but no {what} sidecars "
                "found")
        return gfeat_all, None
    if n_present < len(gfeat_all):
        raise ValueError(
            f"{dirpath}: {n_present}/{len(gfeat_all)} files have {what} "
            "sidecars; all or none must be present")
    gfeat_all, minmax = _minmax_normalize([g[None] for g in gfeat_all])
    return [g[0] for g in gfeat_all], minmax


class LSMSDataset:
    """A directory of LSMS text files -> GraphSamples with radius graphs,
    normalized features and the config's inputs and targets."""

    def __init__(self, config: Dict, dirpath: str):
        ds = config["Dataset"]
        nf = ds["node_features"]
        gf = ds.get("graph_features", {"dim": [], "column_index": []})
        files = sorted(glob.glob(os.path.join(dirpath, "*")))
        files = [f for f in files if os.path.isfile(f)]
        if not files:
            raise FileNotFoundError(f"no LSMS files found in {dirpath}")
        parsed = [parse_lsms_file(
            f, node_feature_dims=nf["dim"],
            node_feature_cols=nf["column_index"],
            graph_feature_dims=gf["dim"],
            graph_feature_cols=gf["column_index"],
            apply_charge_density=ds.get("name", "").startswith("FePt"))
            for f in files]
        node_mats, mm_node = _minmax_normalize([p[0] for p in parsed])
        gfeats = [p[2] for p in parsed]
        mm_graph = None
        if gfeats[0].size:
            gfeats, mm_graph = _minmax_normalize([g[None, :] for g in gfeats])
            gfeats = [g[0] for g in gfeats]
        self.samples = build_graph_samples(
            [dict(node_feature_matrix=n, pos=p[1], graph_feats=g)
             for n, p, g in zip(node_mats, parsed, gfeats)], config)
        normalize_edge_lengths(self.samples)
        self.minmax_node_feature = mm_node
        self.minmax_graph_feature = mm_graph

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i) -> GraphSample:
        return self.samples[i]

    def __iter__(self):
        return iter(self.samples)


def split_with_minmax(config: Dict, total):
    """`Training.perc_train` split of a reader's samples, the train split
    carrying the reader's min-max (`Split`)."""
    perc = config["NeuralNetwork"]["Training"].get("perc_train", 0.7)
    tr, va, te = split_dataset(
        list(total), perc,
        config["Dataset"].get("compositional_stratified_splitting", False))
    return (Split(tr, total.minmax_node_feature, total.minmax_graph_feature),
            va, te)


def load_lsms_splits(config: Dict):
    """(train, val, test) from `Dataset.path`: `total` split by
    `perc_train`, or `train` / `validate` / `test` read one by one."""
    paths = config["Dataset"]["path"]
    if "total" in paths:
        return split_with_minmax(config, LSMSDataset(config, paths["total"]))
    out = [LSMSDataset(config, paths[key])
           for key in ("train", "validate", "test")]
    return (Split(out[0], out[0].minmax_node_feature,
                  out[0].minmax_graph_feature), list(out[1]), list(out[2]))
