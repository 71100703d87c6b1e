"""SMILES CSVs -> splits of GraphSamples (counterparts:
examples/csce/csce_data.py `csce_datasets_load`,
`smiles_sets_to_graphs`; examples/ogb/ogb_data.py `smiles_to_graphs`;
the examples import the JAX package, so the port keeps its own copies,
bitwise).

csce: SMILES at column 1 and the gap at column -2 of one CSV, a seeded
0.6 / 0.2 / 0.2 split, the 6-type CSCE node dictionary (12 node
columns). ogb: every CSV of a directory, SMILES at column 0 and the gap
at the last column (NaN rows skipped), the 31-type dictionary. A
molecule the featurizer cannot type is skipped, as in the examples.
Featurized by utils/smiles_utils.py: bond graphs, not radius graphs.
"""
from __future__ import annotations

import csv
import glob
import math
import os
from typing import List, Optional

import numpy as np

from ..graphs.batch import GraphSample
from ..utils.smiles_utils import generate_graphdata_from_smilestr

CSCE_NODE_TYPES = {"C": 0, "F": 1, "H": 2, "N": 3, "O": 4, "S": 5}

OGB_NODE_TYPES = {
    "H": 0, "B": 1, "C": 2, "N": 3, "O": 4, "F": 5, "Si": 6, "P": 7,
    "S": 8, "Cl": 9, "Ca": 10, "Ge": 11, "As": 12, "Se": 13, "Br": 14,
    "I": 15, "Mg": 16, "Ti": 17, "Ga": 18, "Zn": 19, "Ar": 20, "Be": 21,
    "He": 22, "Al": 23, "Kr": 24, "V": 25, "Na": 26, "Li": 27, "Cu": 28,
    "Ne": 29, "Ni": 30,
}


def csce_datasets_load(datafile: str, sampling: Optional[float] = None,
                       seed: int = 43):
    """(smiles_sets, value_sets, mean, std) of a csce CSV, split 0.6 /
    0.2 / 0.2 by a permutation from `seed`; `sampling` keeps each row
    with that probability."""
    rng = np.random.RandomState(seed)
    smiles_all: List[str] = []
    values_all: List[float] = []
    with open(datafile, newline="") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            if sampling is not None and rng.rand() > sampling:
                continue
            smiles_all.append(row[1])
            values_all.append(float(row[-2]))
    order = rng.permutation(len(smiles_all))
    i0 = int(0.6 * len(order))
    i1 = int(0.8 * len(order))
    sets = []
    vals = []
    for sel in (order[:i0], order[i0:i1], order[i1:]):
        sets.append([smiles_all[i] for i in sel])
        vals.append(np.asarray([values_all[i] for i in sel], np.float32))
    return sets, vals, float(np.mean(values_all)), float(np.std(values_all))


def smiles_sets_to_graphs(smiles_sets, value_sets, norm_yflag=False,
                          ymean=0.0, ystd=1.0, types=None):
    """One list of samples a split (the value the graph target,
    normalized by `ymean` / `ystd` with `norm_yflag`)."""
    out = []
    for smileset, valueset in zip(smiles_sets, value_sets):
        if norm_yflag:
            valueset = (valueset - ymean) / max(ystd, 1e-12)
        samples = []
        for smi, v in zip(smileset, valueset):
            try:
                samples.append(generate_graphdata_from_smilestr(
                    smi, y=np.asarray([v], np.float32),
                    types=types or list(CSCE_NODE_TYPES)))
            except (ValueError, KeyError):
                continue
        out.append(samples)
    return tuple(out)


def csce_splits(datafile: str, sampling: Optional[float] = None,
                norm_yflag: bool = False, seed: int = 43):
    """(train, val, test) samples of a csce CSV, as the csce example
    builds them (examples/csce/train_gap.py)."""
    sets, vals, ymean, ystd = csce_datasets_load(datafile, sampling, seed)
    return smiles_sets_to_graphs(sets, vals, norm_yflag=norm_yflag,
                                 ymean=ymean, ystd=ystd,
                                 types=list(CSCE_NODE_TYPES))


def smiles_to_graphs(datadir: str, limit: Optional[int] = None
                     ) -> List[GraphSample]:
    """The samples of every CSV in `datadir` (else in
    `datadir/synthetic`), in file and row order, up to `limit`."""
    files = sorted(glob.glob(os.path.join(datadir, "*.csv")))
    if not files:
        files = sorted(glob.glob(os.path.join(datadir, "synthetic",
                                              "*.csv")))
    samples = []
    for path in files:
        with open(path, newline="") as f:
            reader = csv.reader(f)
            next(reader)
            for row in reader:
                try:
                    gap = float(row[-1])
                except ValueError:
                    continue
                if math.isnan(gap):
                    continue
                try:
                    samples.append(generate_graphdata_from_smilestr(
                        row[0], y=np.asarray([gap], np.float32),
                        types=list(OGB_NODE_TYPES)))
                except (ValueError, KeyError):
                    continue
                if limit is not None and len(samples) >= limit:
                    return samples
    return samples
