"""Verlet-skin incremental neighbour lists for trajectories (counterpart:
hydragnn_tpu/graphs/neighborlist.py, edge for edge).

* **Build** a cell list at the inflated cutoff `r + skin` and cache the
  candidate pairs and the reference positions (under PBC also the cell,
  its integer-shift table and each candidate's ghost offset).
* **Each step** re-filter the cached candidates to the true cutoff `r`
  at the current positions: a few whole-array numpy ops.
* **Rebuild** only when some atom moved more than `skin / 2` since the
  reference positions (two atoms closing at skin/2 apiece close at most
  `skin`, so any pair inside `r` now was inside `r + skin` then), or when
  the cell changed at all.

The edges an update emits are bitwise those of a fresh `radius_graph` /
`radius_graph_pbc` at the same positions: the candidate cache is the
`_open_pairs` / `_pbc_pairs` enumeration at `r + skin` (a superset of the
fresh pairs, in the same canonical order, which filtering keeps), the
re-filter computes d² with the fresh path's float64 expressions, and
`max_neighbours` keeps the same (d², sender[, shift id]) total order.

Positions must be continuous across steps (unwrapped): an atom wrapped
back into the box jumps by a lattice vector, which reads as a move past
skin/2 and costs a (correct) rebuild.

Host-side numpy. One NeighborList per sequential trajectory client; the
object is not thread-safe.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .radius import (_CAP_DENSE_MAX_DEG, _CAP_DENSE_WASTE,
                     _cap_neighbours, _dense_select, _open_pairs,
                     _pbc_pairs, _segment_layout)

_EMPTY_EDGES = (np.empty(0, np.int32), np.empty(0, np.int32))


class _CandidateCap:
    """`max_neighbours` truncation on the candidate layout. The
    candidates' per-receiver segments are fixed between rebuilds, so the
    segment bookkeeping and the dense [segments, max degree] matrix are
    built once per rebuild, and each step scatters the current d² into it
    (out-of-cutoff candidates as +inf) and selects per row. Candidates
    are in canonical order, so ties on (receiver, d²) break in input
    order, which is the tie keys' order. Degree-skewed candidate sets (the
    guards of `radius._cap_neighbours`) select on the within-cutoff edges
    through `_cap_neighbours` instead: the same selection."""

    __slots__ = ("k", "recv", "seg_id", "idx", "starts", "width", "mat",
                 "keep_all")

    def __init__(self, recv: np.ndarray, k: int):
        self.k = int(k)
        n = len(recv)
        self.seg_id, self.starts, self.idx = _segment_layout(recv)
        self.width = int(self.idx.max()) + 1
        self.keep_all = self.width <= self.k
        dense = (not self.keep_all and self.width <= _CAP_DENSE_MAX_DEG
                 and (len(self.starts) * self.width
                      <= _CAP_DENSE_WASTE * n + 4096))
        self.mat = (np.empty((len(self.starts), self.width)) if dense
                    else None)
        self.recv = None if (self.keep_all or dense) else recv

    def keep(self, d2: np.ndarray, ok: np.ndarray) -> np.ndarray:
        """Keep mask over all candidates: per receiver, the k smallest
        (d², input order) among the `ok` (within-cutoff) ones."""
        if self.k <= 0:
            return np.zeros(len(ok), bool)
        if self.keep_all:
            return ok
        if self.mat is None:
            sel = np.flatnonzero(ok)
            out = np.zeros(len(ok), bool)
            if sel.size:
                kept = _cap_neighbours(d2[sel], self.recv[sel], self.k)
                out[sel[kept]] = True
            return out
        keep = _dense_select(np.where(ok, d2, np.inf), self.seg_id,
                             self.idx, self.starts, self.k, self.mat)
        keep &= ok
        return keep


class NeighborList:
    """Incremental radius-graph builder over a trajectory.

    `update(pos[, cell])` returns `(senders, receivers, shifts, rebuilt)`:
    `shifts` is the [E, 3] float32 cartesian image displacement under PBC
    and None for open boundaries, as `radius_graph_pbc` / `radius_graph`
    emit them. `pbc=None` selects open boundaries; a 3-tuple of bools the
    periodic path (`cell` is then required on every update). `skin <= 0`
    rebuilds every step: the same outputs, no reuse.
    """

    def __init__(self, r: float, skin: float, *,
                 max_neighbours: Optional[int] = None,
                 pbc: Optional[Tuple[bool, bool, bool]] = None):
        self.r = float(r)
        self.skin = float(skin)
        if self.r <= 0.0:
            raise ValueError(f"NeighborList cutoff must be > 0, got {r}")
        if not np.isfinite(self.skin) or self.skin < 0.0:
            raise ValueError(
                f"NeighborList skin must be a finite value >= 0, got {skin}")
        self.max_neighbours = (None if max_neighbours is None
                               else int(max_neighbours))
        self.pbc = None if pbc is None else tuple(bool(p) for p in pbc)
        # `updates` counts update() calls, `rebuilds` the ones that ran
        # the full cell-list construction
        self.updates = 0
        self.rebuilds = 0
        self._ref_pos: Optional[np.ndarray] = None
        self._ref_cell: Optional[np.ndarray] = None
        self._cand: Optional[Tuple[np.ndarray, ...]] = None
        self._shifts_int: Optional[np.ndarray] = None
        self._cand_off: Optional[np.ndarray] = None
        self._cand_d2: Optional[np.ndarray] = None
        self._cap: Optional[_CandidateCap] = None
        self._scratch: Optional[Tuple[np.ndarray, ...]] = None

    @property
    def rebuild_fraction(self) -> float:
        """Rebuilds over updates so far."""
        return self.rebuilds / self.updates if self.updates else 0.0

    def update(self, pos: np.ndarray, cell: Optional[np.ndarray] = None):
        """Edges at the true cutoff for the current positions:
        `(senders, receivers, shifts_or_None, rebuilt)`."""
        pos = np.asarray(pos, dtype=np.float64)
        if self.pbc is not None:
            if cell is None:
                raise ValueError(
                    "periodic NeighborList needs the cell on every "
                    "update (it detects lattice changes and rebuilds)")
            cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
        elif cell is not None:
            raise ValueError(
                "open-boundary NeighborList got a cell — construct with "
                "pbc=(True, True, True) for periodic systems")
        self.updates += 1
        if pos.shape[0] == 0:
            self.rebuilds += 1
            self._ref_pos = pos.copy()
            shifts = (np.empty((0, 3), np.float32)
                      if self.pbc is not None else None)
            return (*_EMPTY_EDGES, shifts, True)
        rebuilt = self._needs_rebuild(pos, cell)
        if rebuilt:
            self.rebuilds += 1
            self._build(pos, cell)
        return (*self._emit(pos, cell, fresh=rebuilt), rebuilt)

    def _needs_rebuild(self, pos: np.ndarray,
                       cell: Optional[np.ndarray]) -> bool:
        if self._ref_pos is None or pos.shape != self._ref_pos.shape:
            return True
        if self.pbc is not None and not np.array_equal(cell,
                                                       self._ref_cell):
            return True
        if self.skin <= 0.0:
            return True
        disp2 = np.sum((pos - self._ref_pos) ** 2, axis=-1)
        # strictly > skin/2: at exactly skin/2 apiece a pair closes by at
        # most `skin`, which the r + skin cache still covers
        return bool(disp2.max() > (0.5 * self.skin) ** 2)

    def _build(self, pos: np.ndarray, cell: Optional[np.ndarray]) -> None:
        rc = self.r + self.skin
        if self.pbc is None:
            send, recv, d2 = _open_pairs(pos, rc)
            self._cand = (send, recv)
        else:
            send, recv, sid, shifts_int, d2 = _pbc_pairs(pos, cell, rc,
                                                         self.pbc)
            self._cand = (send, recv, sid)
            self._shifts_int = shifts_int
            # candidate e sits at pos[send] + (shifts_int @ cell)[sid[e]]:
            # the float64 values `_pbc_pairs` added to its ghosts
            self._cand_off = (shifts_int @ cell)[sid]
            self._ref_cell = cell.copy()
        # the enumeration's own d², valid at the unmoved build positions
        self._cand_d2 = d2
        self._cap = (None if self.max_neighbours is None or not len(recv)
                     else _CandidateCap(recv, self.max_neighbours))
        self._scratch = None
        self._ref_pos = pos.copy()

    def export_candidates(self):
        """The current candidate cache: `(senders, receivers, offsets,
        cart_shifts_f32, ref_pos)`, int64 pairs in the canonical order,
        the per-candidate float64 ghost offsets and float32 cartesian
        shifts (None for open boundaries), and the reference positions.
        Raises before the first update."""
        if self._cand is None:
            raise RuntimeError(
                "export_candidates: no candidate cache — call update() "
                "(which builds on first use) before exporting")
        if self.pbc is None:
            cs, cr = self._cand
            return cs, cr, None, None, self._ref_pos
        cs, cr, _ = self._cand
        return (cs, cr, self._cand_off,
                self._cand_off.astype(np.float32), self._ref_pos)

    def _cand_distances(self, pos: np.ndarray, fresh: bool) -> np.ndarray:
        """Per-candidate d² at the current positions: on the rebuild step
        the enumeration's own, else computed in preallocated scratch with
        the fresh expression's operations in its order (the same
        values)."""
        if fresh:
            return self._cand_d2
        cs, cr = self._cand[:2]
        if self._scratch is None or self._scratch[0].shape[0] != len(cs):
            self._scratch = (np.empty((len(cs), 3), np.float64),
                             np.empty((len(cs), 3), np.float64),
                             np.empty(len(cs), np.float64))
        g, h, d2 = self._scratch
        np.take(pos, cs, axis=0, out=g)
        if self.pbc is not None:
            g += self._cand_off
        g -= np.take(pos, cr, axis=0, out=h)
        np.multiply(g, g, out=g)
        return np.sum(g, axis=1, out=d2)

    def _emit(self, pos: np.ndarray, cell: Optional[np.ndarray],
              fresh: bool = False):
        """Re-filter the candidate cache to the true cutoff at `pos`."""
        d2 = self._cand_distances(pos, fresh)
        keep = d2 <= self.r * self.r
        if self._cap is not None:
            keep = self._cap.keep(d2, keep)
        if self.pbc is None:
            cs, cr = self._cand
            return (cs[keep].astype(np.int32), cr[keep].astype(np.int32),
                    None)
        cs, cr, csid = self._cand
        send, recv, sid = cs[keep], cr[keep], csid[keep]
        cart_shift = (self._shifts_int[sid] @ cell).astype(np.float32)
        return send.astype(np.int32), recv.astype(np.int32), cart_shift
