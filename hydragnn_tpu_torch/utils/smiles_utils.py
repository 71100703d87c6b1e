"""SMILES -> GraphSample (counterpart: hydragnn_tpu/utils/smiles_utils.py,
copied).

x = [type one-hot, atomic number, IsAromatic, SP, SP2, SP3, number of
bonded H] and a bond-type one-hot `edge_attr` [single, double, triple,
aromatic], both directions of every bond, positions zero. rdkit is used
when it can be imported; without it a built-in parser covers the organic
subset (B C N O P S F Cl Br I, aromatic lower case, rings, branches, - =
# bonds, brackets), adds implicit hydrogens from standard valences and
estimates the hybridization from bond orders. Only the built-in parser
is held against the JAX package: neither the test machines nor the
card's have rdkit.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graphs.batch import GraphSample
from .elements import SYMBOL_TO_Z

_ORGANIC = ["C", "F", "H", "N", "O", "S"]
_Z = dict(SYMBOL_TO_Z)           # full periodic table for bracket atoms
_SYM = {z: s for s, z in SYMBOL_TO_Z.items()}
# implicit-H completion valences; elements absent here get no implicit H
_VALENCE = {"H": 1, "B": 3, "C": 4, "N": 3, "O": 2, "F": 1, "P": 3,
            "S": 2, "Cl": 1, "Br": 1, "I": 1, "Si": 4, "Se": 2, "Ge": 4,
            "As": 3, "Al": 3}

# bond-type one-hot indices (reference: smiles_utils.py:52 bonds dict)
BOND_TYPES = {1: 0, 2: 1, 3: 2, 4: 3}      # single, double, triple, aromatic

_TOKEN = re.compile(
    r"(\[[^\]]+\]|Cl|Br|[BCNOPSFI]|[bcnops]|=|#|\(|\)|[0-9]|%[0-9]{2}|[-+.\\/])")


def get_node_attribute_name(types: Optional[Sequence[str]] = None):
    """reference: smiles_utils.py:17-32."""
    types = list(types or _ORGANIC)
    names = ["atom" + t for t in types] + [
        "atomicnumber", "IsAromatic", "HSP", "HSP2", "HSP3", "Hprop"]
    return names, [1] * len(names)


def parse_smiles(smiles: str):
    """Minimal SMILES parser -> (atomic_numbers, bonds(i, j, type),
    aromatic_flags); bond type 1/2/3/4 with 4 = aromatic."""
    atoms: List[int] = []
    aromatic: List[bool] = []
    bonds: List[Tuple[int, int, int]] = []
    stack: List[int] = []
    prev = -1
    order = 0  # 0 = default (single, or aromatic if both ends aromatic)
    rings: Dict[str, Tuple[int, int]] = {}

    def _bond(i, j, o):
        if o == 0:
            o = 4 if (aromatic[i] and aromatic[j]) else 1
        bonds.append((i, j, o))

    for tok in _TOKEN.findall(smiles):
        if tok == "(":
            stack.append(prev)
        elif tok == ")":
            prev = stack.pop()
        elif tok == "=":
            order = 2
        elif tok == "#":
            order = 3
        elif tok == ".":
            prev = -1
            order = 0
        elif tok in ("-", "/", "\\", "+"):
            order = 0 if tok != "-" else 1
        elif tok.isdigit() or tok.startswith("%"):
            if tok in rings:
                j, o = rings.pop(tok)
                _bond(prev, j, max(order, o))
            else:
                rings[tok] = (prev, order)
            order = 0
        else:
            if tok.startswith("["):
                m = re.match(r"\[[0-9]*([A-Za-z][a-z]?)", tok)
                sym = m.group(1)
                is_arom = sym.islower()
                sym = sym.capitalize()
            else:
                is_arom = tok.islower()
                sym = tok.capitalize() if tok in "bcnops" else tok
            z = _Z.get(sym)
            if z is None:
                raise ValueError(f"unsupported atom '{tok}' in '{smiles}'")
            atoms.append(z)
            aromatic.append(is_arom)
            idx = len(atoms) - 1
            if prev >= 0:
                _bond(prev, idx, order)
            prev = idx
            order = 0
    return atoms, bonds, aromatic


def _add_implicit_hydrogens(atoms, bonds, aromatic):
    """Standard-valence H completion (the rdkit AddHs equivalent)."""
    used = [0.0] * len(atoms)
    for i, j, o in bonds:
        val = 1.5 if o == 4 else float(o)
        used[i] += val
        used[j] += val
    atoms = list(atoms)
    bonds = list(bonds)
    aromatic = list(aromatic)
    n_heavy = len(atoms)
    for i in range(n_heavy):
        sym = _SYM[atoms[i]]
        free = _VALENCE.get(sym, 0) - int(round(used[i]))
        for _ in range(max(0, free)):
            atoms.append(1)
            aromatic.append(False)
            bonds.append((i, len(atoms) - 1, 1))
    return atoms, bonds, aromatic


def _features_from_parsed(atoms, bonds, aromatic, types, hybrid=None):
    """`hybrid`: optional exact [n,3] sp/sp2/sp3 one-hots (rdkit path);
    estimated from bond orders when None."""
    n = len(atoms)
    type_idx = np.zeros((n, len(types)), np.float32)
    for i, z in enumerate(atoms):
        sym = _SYM[z]
        if sym not in types:
            # reference indexes types[atom.GetSymbol()] and lets KeyError
            # propagate (smiles_utils.py:64); callers skip such molecules
            raise KeyError(
                f"atom {sym!r} not in the node-type dictionary {types}")
        type_idx[i, list(types).index(sym)] = 1.0
    z_arr = np.asarray(atoms, np.float32)
    arom = np.asarray(aromatic, np.float32)
    # hybridization estimate: sp = triple or >=2 doubles; sp2 = aromatic or
    # one double; sp3 = saturated heavy atom
    n_double = np.zeros(n)
    n_triple = np.zeros(n)
    num_h = np.zeros(n)
    for i, j, o in bonds:
        if o == 2:
            n_double[i] += 1
            n_double[j] += 1
        elif o == 3:
            n_triple[i] += 1
            n_triple[j] += 1
        if atoms[j] == 1:
            num_h[i] += 1
        if atoms[i] == 1:
            num_h[j] += 1
    if hybrid is not None:
        sp, sp2, sp3 = hybrid[:, 0], hybrid[:, 1], hybrid[:, 2]
    else:
        sp = ((n_triple > 0) | (n_double >= 2)).astype(np.float32)
        sp2 = ((arom > 0) | ((n_double == 1) & (n_triple == 0))).astype(
            np.float32)
        sp2 = np.where(sp > 0, 0.0, sp2)
        heavy = z_arr > 1
        sp3 = (heavy & (sp == 0) & (sp2 == 0)).astype(np.float32)
    x = np.concatenate([
        type_idx, z_arr[:, None], arom[:, None], sp[:, None], sp2[:, None],
        sp3[:, None], num_h[:, None]], axis=1).astype(np.float32)
    return x


def generate_graphdata_from_smilestr(
        smiles: str, y: Optional[np.ndarray] = None,
        types: Optional[Sequence[str]] = None) -> GraphSample:
    """SMILES string -> GraphSample with the reference's feature layout
    (reference: smiles_utils.py:49-121): x = [type one-hot, Z, aromatic,
    sp, sp2, sp3, numH], edge_attr = bond-type one-hot [4]."""
    types = list(types or _ORGANIC)
    hybrid = None
    try:
        from rdkit import Chem
        from rdkit.Chem.rdchem import BondType as BT
        from rdkit.Chem.rdchem import HybridizationType as HT
        ps = Chem.SmilesParserParams()
        ps.removeHs = False
        mol = Chem.MolFromSmiles(smiles, ps)
        if mol is None:
            raise ValueError(f"rdkit could not parse SMILES {smiles!r}")
        mol = Chem.AddHs(mol)
        atoms = [a.GetAtomicNum() for a in mol.GetAtoms()]
        aromatic = [a.GetIsAromatic() for a in mol.GetAtoms()]
        # exact hybridization one-hots from rdkit (reference:
        # smiles_utils.py:66-70)
        hybrid = np.zeros((len(atoms), 3), np.float32)
        for i, a in enumerate(mol.GetAtoms()):
            h = a.GetHybridization()
            if h == HT.SP:
                hybrid[i, 0] = 1.0
            elif h == HT.SP2:
                hybrid[i, 1] = 1.0
            elif h == HT.SP3:
                hybrid[i, 2] = 1.0
        bt = {BT.SINGLE: 1, BT.DOUBLE: 2, BT.TRIPLE: 3, BT.AROMATIC: 4}
        bonds = [(b.GetBeginAtomIdx(), b.GetEndAtomIdx(),
                  bt.get(b.GetBondType(), 1)) for b in mol.GetBonds()]
    except ImportError:
        atoms, bonds, aromatic = parse_smiles(smiles)
        atoms, bonds, aromatic = _add_implicit_hydrogens(
            atoms, bonds, aromatic)
    x = _features_from_parsed(atoms, bonds, aromatic, types, hybrid=hybrid)
    send, recv, etype = [], [], []
    for i, j, o in bonds:
        send += [i, j]
        recv += [j, i]
        etype += [BOND_TYPES[o], BOND_TYPES[o]]
    edge_attr = np.zeros((len(etype), 4), np.float32)
    if etype:
        edge_attr[np.arange(len(etype)), etype] = 1.0
    return GraphSample(
        x=x, pos=np.zeros((len(atoms), 3), np.float32),
        senders=np.asarray(send, np.int32),
        receivers=np.asarray(recv, np.int32),
        edge_attr=edge_attr, y_graph=y)
