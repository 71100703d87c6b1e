"""Extended-XYZ (extxyz) multi-frame reader and writer (counterpart:
hydragnn_tpu/datasets/extxyz.py, copied).

The standard layout, with no ase: line 0 the atom count, line 1 a
key=value comment (Lattice="9 floats",
Properties=species:S:1:pos:R:3[:forces:R:3...], energy=...,
free_energy=...), then one row per atom. The OC20 and OC22 examples keep
their frames in this form (datasets/atomistic.py reads them).
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.elements import SYMBOLS, symbol_to_z

_KV = re.compile(r'(\w+)=(?:"([^"]*)"|(\S+))')


def _parse_comment(line: str) -> Dict[str, str]:
    return {m.group(1): (m.group(2) if m.group(2) is not None else m.group(3))
            for m in _KV.finditer(line)}


def _parse_properties(spec: str) -> List[Tuple[str, str, int]]:
    tok = spec.split(":")
    return [(tok[i], tok[i + 1], int(tok[i + 2]))
            for i in range(0, len(tok), 3)]


class Frame:
    """One extxyz frame: z [N], pos [N,3], cell [3,3] or None, per-atom
    arrays (e.g. forces), and the comment-line scalars (energy, ...)."""

    __slots__ = ("z", "pos", "cell", "arrays", "info")

    def __init__(self, z, pos, cell, arrays, info):
        self.z = z
        self.pos = pos
        self.cell = cell
        self.arrays = arrays
        self.info = info


def iread_extxyz(path: str) -> Iterator[Frame]:
    with open(path, encoding="utf-8") as f:
        while True:
            header = f.readline()
            if not header.strip():
                return
            natoms = int(header)
            info = _parse_comment(f.readline())
            props = _parse_properties(
                info.get("Properties", "species:S:1:pos:R:3"))
            cell = None
            if "Lattice" in info:
                cell = np.fromstring(info["Lattice"], sep=" ",
                                     dtype=np.float32).reshape(3, 3)
            cols: Dict[str, List] = {name: [] for name, _, _ in props}
            for _ in range(natoms):
                tok = f.readline().split()
                i = 0
                for name, kind, ncol in props:
                    vals = tok[i:i + ncol]
                    i += ncol
                    cols[name].append(vals[0] if kind == "S" and ncol == 1
                                      else [float(v) for v in vals])
            z = np.asarray([symbol_to_z(s) for s in cols.pop("species")],
                           np.float32)
            pos = np.asarray(cols.pop("pos"), np.float32)
            arrays = {k: np.asarray(v, np.float32) for k, v in cols.items()}
            scalars = {}
            for k, v in info.items():
                if k in ("Lattice", "Properties"):
                    continue
                try:
                    scalars[k] = float(v)
                except ValueError:
                    scalars[k] = v
            yield Frame(z, pos, cell, arrays, scalars)


def read_extxyz(path: str, limit: Optional[int] = None) -> List[Frame]:
    out = []
    for frame in iread_extxyz(path):
        out.append(frame)
        if limit is not None and len(out) >= limit:
            break
    return out


def write_extxyz(path: str, frames: List[Frame], mode: str = "w") -> None:
    with open(path, mode, encoding="utf-8") as f:
        for fr in frames:
            n = len(fr.z)
            parts = []
            if fr.cell is not None:
                lat = " ".join(f"{v:.8f}" for v in
                               np.asarray(fr.cell).reshape(-1))
                parts.append(f'Lattice="{lat}"')
            prop = "species:S:1:pos:R:3"
            extra = sorted(fr.arrays)
            for k in extra:
                prop += f":{k}:R:{fr.arrays[k].shape[1]}"
            parts.append(f"Properties={prop}")
            for k, v in fr.info.items():
                parts.append(f"{k}={v}")
            f.write(f"{n}\n{' '.join(parts)}\n")
            for i in range(n):
                row = [SYMBOLS[int(fr.z[i])]]
                row += [f"{v:.8f}" for v in fr.pos[i]]
                for k in extra:
                    row += [f"{v:.8f}" for v in fr.arrays[k][i]]
                f.write(" ".join(row) + "\n")
