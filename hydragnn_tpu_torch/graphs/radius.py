"""Radius graphs on the host in numpy (counterpart:
hydragnn_tpu/graphs/radius.py: `radius_graph`, `radius_graph_pbc` and
what they call).

Open boundaries (`radius_graph`): all pairs within `r`, both directions,
receiver-major and sender-ascending; up to `_DENSE_MAX` atoms from the
dense N x N distances, above it from a cell list over the occupied cells
(the same pairs in the same order, so the boundary does not show).

Ghost/image atoms: every periodic image within the shift range is
materialized once, pruned to the bounding box of the real atoms inflated
by `r`, and a cell list over the occupied cells finds the real -> ghost
pairs. The edges come out bitwise as the JAX package builds them:

* in the canonical order: receiver-major, then sender, then shift id
  (shift ids enumerate the integer images (sx, sy, sz) lexicographically);
* `max_neighbours` keeps, per receiver, the k smallest
  (d², sender, shift id), a total order, so the kept set does not depend
  on the order of construction.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

_EMPTY_I64 = np.empty(0, np.int64)

# up to this many atoms the open-boundary pairs come from the dense N x N
# distances; above it from the cell list (edge for edge the same)
_DENSE_MAX = 512

# dense-cap guards: above this row width, or past this padding-waste
# factor, the [segments, max_degree] selection matrix stops paying off
_CAP_DENSE_MAX_DEG = 2048
_CAP_DENSE_WASTE = 8


def radius_graph(
    pos: np.ndarray,
    r: float,
    max_neighbours: Optional[int] = None,
    loop: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """(senders, receivers) of every pair within `r`, both directions;
    `max_neighbours` keeps, per receiver, the k smallest (d², sender)."""
    pos = np.asarray(pos, dtype=np.float64)
    n = pos.shape[0]
    if n == 0:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    send, recv, d2 = _open_pairs(pos, r, loop)
    if max_neighbours is not None and len(recv):
        keep = _cap_neighbours(d2, recv, max_neighbours)
        send, recv = send[keep], recv[keep]
    return send.astype(np.int32), recv.astype(np.int32)


def _open_pairs(pos, r, loop=False):
    """All uncapped (send, recv, d²) open-boundary pairs within `r`,
    receiver-major and sender-ascending; `pos` is float64."""
    n = pos.shape[0]
    if n <= _DENSE_MAX:
        d2 = np.sum((pos[:, None, :] - pos[None, :, :]) ** 2, axis=-1)
        adj = d2 <= r * r
        if not loop:
            np.fill_diagonal(adj, False)
        recv, send = np.nonzero(adj)  # row i = receiver, column j = sender
        return send, recv, d2[recv, send]
    return _cell_list_pairs(pos, r, loop)


def _cell_list_pairs(pos, r, loop):
    """`_open_pairs` above `_DENSE_MAX` atoms, from the cell list."""
    r2 = r * r
    send_l, recv_l, d2_l = [], [], []
    for cand, center in _cell_candidate_blocks(pos, pos, r):
        d2 = np.sum((pos[cand] - pos[center]) ** 2, axis=-1)
        ok = d2 <= r2
        if not loop:
            ok &= cand != center
        send_l.append(cand[ok])
        recv_l.append(center[ok])
        d2_l.append(d2[ok])
    send = np.concatenate(send_l) if send_l else _EMPTY_I64
    recv = np.concatenate(recv_l) if recv_l else _EMPTY_I64
    d2 = np.concatenate(d2_l) if d2_l else np.empty(0, np.float64)
    order = np.lexsort((send, recv))
    return send[order], recv[order], d2[order]


def radius_graph_pbc(
    pos: np.ndarray,
    cell: np.ndarray,
    r: float,
    pbc: Tuple[bool, bool, bool] = (True, True, True),
    max_neighbours: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(senders, receivers, shifts) of every pair within `r` under
    periodic boundaries; the displacement of edge k is
    pos[send] + shifts[k] - pos[recv]."""
    pos = np.asarray(pos, dtype=np.float64)
    cell = np.asarray(cell, dtype=np.float64).reshape(3, 3)
    n = pos.shape[0]
    if n == 0:
        return (np.empty(0, np.int32), np.empty(0, np.int32),
                np.empty((0, 3), np.float32))
    send, recv, sid, shifts_int, d2 = _pbc_pairs(pos, cell, r, pbc)
    shift = shifts_int[sid]
    if max_neighbours is not None and len(recv):
        keep = _cap_neighbours(d2, recv, max_neighbours)
        send, recv, shift = send[keep], recv[keep], shift[keep]
    cart_shift = (shift @ cell).astype(np.float32)
    return send.astype(np.int32), recv.astype(np.int32), cart_shift


def _pbc_pairs(pos, cell, r, pbc=(True, True, True)):
    """All uncapped periodic pairs within `r`: (send, recv, sid,
    shifts_int, d²) in the canonical (receiver, sender, shift id) order;
    `pos` and `cell` are float64."""
    n = pos.shape[0]
    # images needed per axis: ceil(r / distance between lattice planes)
    recip = np.linalg.inv(cell).T
    nmax = []
    for a in range(3):
        if pbc[a]:
            plane_d = 1.0 / np.linalg.norm(recip[a])
            nmax.append(int(np.ceil(r / plane_d)))
        else:
            nmax.append(0)
    ax = [np.arange(-m, m + 1) for m in nmax]
    sx, sy, sz = np.meshgrid(ax[0], ax[1], ax[2], indexing="ij")
    shifts_int = np.stack([sx.ravel(), sy.ravel(), sz.ravel()],
                          axis=1).astype(np.float64)  # [S, 3]
    s_total = shifts_int.shape[0]
    zero_id = int(np.nonzero((shifts_int == 0).all(axis=1))[0][0])

    # ghosts: image s of atom j lands at index s*n + j
    ghost_pos = (pos[None, :, :]
                 + (shifts_int @ cell)[:, None, :]).reshape(-1, 3)
    ghost_src = np.tile(np.arange(n, dtype=np.int64), s_total)
    ghost_sid = np.repeat(np.arange(s_total, dtype=np.int64), n)
    # prune images that cannot reach any real atom; the zero-shift block
    # always stays, so the grid holds every query point
    lo, hi = pos.min(axis=0) - r, pos.max(axis=0) + r
    keep = np.logical_and(ghost_pos >= lo, ghost_pos <= hi).all(axis=1)
    keep[zero_id * n:(zero_id + 1) * n] = True
    ghost_pos = ghost_pos[keep]
    ghost_src = ghost_src[keep]
    ghost_sid = ghost_sid[keep]

    r2 = r * r
    send_l, recv_l, sid_l, d2_l = [], [], [], []
    for cand, center in _cell_candidate_blocks(ghost_pos, pos, r):
        d2 = np.sum((ghost_pos[cand] - pos[center]) ** 2, axis=-1)
        ok = d2 <= r2
        # only the self edge in the home image is excluded; images of the
        # same atom are neighbours in a small cell
        ok &= ~((ghost_src[cand] == center) & (ghost_sid[cand] == zero_id))
        send_l.append(ghost_src[cand[ok]])
        recv_l.append(center[ok])
        sid_l.append(ghost_sid[cand[ok]])
        d2_l.append(d2[ok])
    send = np.concatenate(send_l) if send_l else _EMPTY_I64
    recv = np.concatenate(recv_l) if recv_l else _EMPTY_I64
    sid = np.concatenate(sid_l) if sid_l else _EMPTY_I64
    d2 = np.concatenate(d2_l) if d2_l else np.empty(0, np.float64)
    order = np.lexsort((sid, send, recv))
    return send[order], recv[order], sid[order], shifts_int, d2[order]


def _compress_cells(coords: np.ndarray) -> np.ndarray:
    """Per-axis compression of integer cell coordinates through their
    sorted unique values with gaps clamped to 2: same and adjacent cells
    stay 0 and 1 apart, farther ones become exactly 2 apart."""
    out = np.empty_like(coords)
    for a in range(coords.shape[1]):
        u = np.unique(coords[:, a])
        comp = np.concatenate(([0], np.cumsum(np.minimum(np.diff(u), 2))))
        out[:, a] = comp[np.searchsorted(u, coords[:, a])]
    return out


def _cell_candidate_blocks(grid_pos, query_pos, r):
    """Yield (cand, center) index blocks, one per of the 27 cell offsets:
    the grid points in cell(center) + offset for every query point. Only
    occupied cells are materialized. The query points are a subset of the
    grid points."""
    mins = grid_pos.min(axis=0)
    # bin width a hair above r: a pair at distance exactly r never lands
    # two cells apart through rounding of the floor
    inv = 1.0 / (float(r) * (1.0 + 1e-9))
    gcell = np.floor((grid_pos - mins) * inv).astype(np.int64)
    qcell = np.floor((query_pos - mins) * inv).astype(np.int64)
    both = _compress_cells(np.concatenate([gcell, qcell]))
    gcell, qcell = both[: len(gcell)], both[len(gcell):]
    dims = gcell.max(axis=0) + 1
    gkey = (gcell[:, 0] * dims[1] + gcell[:, 1]) * dims[2] + gcell[:, 2]
    order = np.argsort(gkey, kind="stable")
    skey = gkey[order]
    uniq, starts = np.unique(skey, return_index=True)
    counts = np.diff(np.append(starts, len(skey)))
    nq = qcell.shape[0]
    centers = np.arange(nq, dtype=np.int64)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nc = qcell + (dx, dy, dz)
                valid = np.logical_and(nc >= 0, nc < dims).all(axis=1)
                nkey = (nc[:, 0] * dims[1] + nc[:, 1]) * dims[2] + nc[:, 2]
                j = np.searchsorted(uniq, nkey)
                jc = np.minimum(j, len(uniq) - 1)
                hit = valid & (uniq[jc] == nkey)
                cnt = np.where(hit, counts[jc], 0)
                total = int(cnt.sum())
                if total == 0:
                    continue
                center = np.repeat(centers, cnt)
                intra = np.arange(total) - np.repeat(
                    np.cumsum(cnt) - cnt, cnt)
                cand = order[np.repeat(starts[jc], cnt) + intra]
                yield cand, center


def _segment_layout(recv):
    """(segment id, segment starts, index within the segment) of a
    non-empty receiver-major array."""
    n = len(recv)
    change = np.empty(n, bool)
    change[0] = True
    np.not_equal(recv[1:], recv[:-1], out=change[1:])
    seg_id = np.cumsum(change, dtype=np.int64) - 1
    starts = np.flatnonzero(change)
    idx = np.arange(n, dtype=np.int64) - starts[seg_id]
    return seg_id, starts, idx


def _cap_neighbours(d2, recv, max_neighbours):
    """Keep mask selecting, per receiver, the `max_neighbours` edges that
    are smallest under (d², sender, shift id). The input is in the
    canonical (receiver, sender, shift id) order, so a stable selection
    by d² breaks ties in input order, which is the tie keys' order (the
    JAX package's `_cap_neighbours(..., canonical_order=True)`; every
    caller here and in graphs/neighborlist.py has that order)."""
    if max_neighbours <= 0:
        return np.zeros(len(recv), bool)
    n_edges = len(recv)
    seg_id, starts, idx = _segment_layout(recv)
    n_seg = len(starts)
    width = int(idx.max()) + 1
    if (width > _CAP_DENSE_MAX_DEG
            or n_seg * width > _CAP_DENSE_WASTE * n_edges + 4096):
        order = np.lexsort((d2, recv))  # stable: ties keep input order
        srecv = recv[order]
        rank = (np.arange(n_edges)
                - np.searchsorted(srecv, srecv, side="left"))
        keep = np.zeros(n_edges, bool)
        keep[order[rank < max_neighbours]] = True
        return keep
    if width <= max_neighbours:
        return np.ones(n_edges, bool)
    mat = np.empty((n_seg, width))
    return _dense_select(d2, seg_id, idx, starts, max_neighbours, mat)


def _dense_select(val, seg_id, idx, starts, k, mat):
    """Keep mask: per contiguous segment, the k smallest entries under
    (val, input order): everything strictly below the row's k-th smallest
    value, plus the first (k - that many) entries equal to it."""
    mat.fill(np.inf)
    mat[seg_id, idx] = val
    kth = np.partition(mat, k - 1, axis=1)[:, k - 1]
    kth_e = kth[seg_id]
    strict = val < kth_e
    quota = k - np.add.reduceat(strict, starts)
    eq = val == kth_e
    run = np.cumsum(eq, dtype=np.int64)
    base = run[starts] - eq[starts]
    eq_rank = run - base[seg_id]
    return strict | (eq & (eq_rank <= quota[seg_id]))
