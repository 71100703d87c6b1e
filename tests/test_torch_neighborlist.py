"""The port's Verlet-skin neighbour list (hydragnn_tpu_torch/graphs/
neighborlist.py) against the JAX package's, bitwise: the same seeded
trajectories go through both lists, and at every step `send`, `recv`,
`shifts` and `rebuilt` must be equal, and the edges equal to a fresh
`radius_graph[_pbc]` of the port. Cases: open boundaries and PBC, caps
with ties, skewed degrees (the cap's lexsort fallback), zero skin, a
cell change, an atom-count change and the empty system. The properties
of tests/test_neighborlist.py (a brute-force oracle, the rebuild exactly
at skin/2, the validation errors, the candidate cap against the JAX
package's generic total order) run on the port as cases of one test.
"""
import numpy as np
import pytest

from hydragnn_tpu.graphs.neighborlist import NeighborList as JNeighborList
from hydragnn_tpu.graphs.radius import _cap_neighbours as j_cap_neighbours
from hydragnn_tpu_torch.graphs.neighborlist import (NeighborList,
                                                    _CandidateCap)
from hydragnn_tpu_torch.graphs.radius import (_cap_neighbours, radius_graph,
                                              radius_graph_pbc)


def _walk(rng, pos, steps, scale):
    frames = []
    for _ in range(steps):
        pos = pos + rng.randn(*pos.shape) * scale
        frames.append(pos)
    return frames


def _lattice(nd, box, rng, jitter):
    grid = np.stack(np.meshgrid(*[np.arange(nd)] * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3) * (box / nd)
    return grid + rng.rand(nd ** 3, 3) * jitter


def _open_case(n, cap, steps=20, scale=0.01):
    def make():
        rng = np.random.RandomState(n)
        pos = rng.rand(n, 3) * (n ** (1 / 3.0))
        return ([(p, None) for p in _walk(rng, pos, steps, scale)],
                dict(r=0.6, skin=0.2, max_neighbours=cap, pbc=None))
    return make


def _pbc_case(nd, box, r, cap, steps=20):
    def make():
        rng = np.random.RandomState(nd)
        cell = np.eye(3) * box
        pos = _lattice(nd, box, rng, 0.03)
        return ([(p, cell) for p in _walk(rng, pos, steps, 0.008)],
                dict(r=r, skin=0.3, max_neighbours=cap,
                     pbc=(True, True, True)))
    return make


def _skewed_case():
    """A dense cluster beside thousands of far-apart pairs: one candidate
    segment ~300 wide next to ~3,000 of width 1, so the capped list takes
    `_CandidateCap`'s lexsort fallback."""
    def make():
        rng = np.random.RandomState(11)
        cluster = rng.rand(300, 3) * 0.3
        base = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"),
                        axis=-1).reshape(-1, 3)[:1500] * 3.0 + 5.0
        pairs = np.concatenate([base, base + [0.4, 0.0, 0.0]])
        pos = np.concatenate([cluster, pairs])
        return ([(p, None) for p in _walk(rng, pos, 6, 0.004)],
                dict(r=0.6, skin=0.2, max_neighbours=5, pbc=None))
    return make


def _zero_skin_case():
    def make():
        rng = np.random.RandomState(2)
        pos = rng.rand(50, 3) * 2.0
        return ([(p, None) for p in _walk(rng, pos, 5, 1e-6)],
                dict(r=0.7, skin=0.0, max_neighbours=4, pbc=None))
    return make


def _cell_change_case():
    def make():
        rng = np.random.RandomState(1)
        cell = np.eye(3) * 4.0
        pos = rng.rand(40, 3) * 4.0
        frames = [(pos, cell), (pos, cell), (pos, cell * 1.0005),
                  (pos + 1e-3, cell * 1.0005), (pos, cell)]
        return frames, dict(r=1.0, skin=0.3, max_neighbours=6,
                            pbc=(True, True, True))
    return make


def _count_change_case():
    def make():
        rng = np.random.RandomState(4)
        pos = rng.rand(30, 3)
        more = np.concatenate([pos, rng.rand(1, 3)])
        frames = [np.zeros((0, 3)), pos, pos + 1e-3, more, more + 1e-3,
                  np.zeros((0, 3)), pos]
        return ([(p, None) for p in frames],
                dict(r=0.5, skin=0.3, max_neighbours=None, pbc=None))
    return make


def _empty_pbc_case():
    def make():
        cell = np.eye(3) * 3.0
        return ([(np.zeros((0, 3)), cell)] * 2,
                dict(r=1.0, skin=0.3, max_neighbours=4,
                     pbc=(True, True, True)))
    return make


TRAJECTORIES = {
    "open_n40": _open_case(40, None),
    "open_n40_cap6": _open_case(40, 6),
    "open_n513_cap6_cell_list": _open_case(513, 6),
    "open_n530_uncapped": _open_case(530, None),
    "pbc_tiny_cell": _pbc_case(2, 2.0, 1.9, None),
    "pbc_tiny_cell_cap_ties": _pbc_case(2, 2.0, 1.9, 8),
    "pbc_cap8": _pbc_case(5, 6.0, 2.0, 8),
    "skewed_degrees": _skewed_case(),
    "zero_skin": _zero_skin_case(),
    "cell_change": _cell_change_case(),
    "atom_count_change": _count_change_case(),
    "empty_pbc": _empty_pbc_case(),
}


@pytest.mark.parametrize("case", sorted(TRAJECTORIES))
def test_neighborlist_matches_jax_and_fresh_bitwise(case):
    frames, kw = TRAJECTORIES[case]()
    args = (kw["r"], kw["skin"])
    opts = dict(max_neighbours=kw["max_neighbours"], pbc=kw["pbc"])
    ours, theirs = NeighborList(*args, **opts), JNeighborList(*args, **opts)
    for step, (pos, cell) in enumerate(frames):
        got = ours.update(pos, cell=cell)
        want = theirs.update(pos, cell=cell)
        assert got[3] == want[3], (case, step)
        for a, b in zip(got[:3], want[:3]):
            assert (a is None) == (b is None), (case, step)
            if a is not None:
                assert a.dtype == b.dtype, (case, step)
                np.testing.assert_array_equal(a, b, err_msg=f"{case}@{step}")
        if kw["pbc"] is None:
            fresh = radius_graph(pos, kw["r"],
                                 max_neighbours=kw["max_neighbours"])
        else:
            fresh = radius_graph_pbc(pos, cell, kw["r"],
                                     max_neighbours=kw["max_neighbours"])
        for a, b in zip(got, fresh):
            np.testing.assert_array_equal(a, b, err_msg=f"{case}@{step}")
    assert (ours.updates, ours.rebuilds) == (theirs.updates, theirs.rebuilds)
    assert ours.rebuild_fraction == theirs.rebuild_fraction
    if case.startswith(("open_", "pbc_")):
        assert 0 < ours.rebuilds < ours.updates, "no candidate reuse"
    if case == "skewed_degrees":
        assert ours._cap.mat is None and not ours._cap.keep_all
    if case == "zero_skin":
        assert ours.rebuilds == ours.updates
    if len(frames[0][0]):
        for a, b in zip(ours.export_candidates(),
                        theirs.export_candidates()):
            if a is not None:
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ properties --

def _prop_bruteforce_oracle():
    """Between rebuilds no pair within the cutoff is dropped and none
    beyond it emitted (an O(N²) oracle of neither implementation)."""
    rng = np.random.RandomState(3)
    n, r = 120, 0.7
    nl = NeighborList(r, 0.25)
    for step, pos in enumerate(_walk(rng, rng.rand(n, 3) * 3.0, 30, 0.012)):
        send, recv, _, _ = nl.update(pos)
        d2 = np.sum((pos[:, None] - pos[None, :]) ** 2, axis=-1)
        adj = d2 <= r * r
        np.fill_diagonal(adj, False)
        o_recv, o_send = np.nonzero(adj)
        assert (set(zip(send.tolist(), recv.tolist()))
                == set(zip(o_send.tolist(), o_recv.tolist()))), step
    assert nl.rebuilds < nl.updates


def _prop_rebuild_exactly_past_skin_half():
    """A move of exactly skin/2 reuses the cache; one past it rebuilds,
    and the next move is measured from the new reference."""
    rng = np.random.RandomState(0)
    skin = 0.25
    pos = rng.rand(60, 3) * 3.0
    pos[7, 0] = 1.0
    nl = NeighborList(0.8, skin)
    nl.update(pos)
    at_bound = pos.copy()
    at_bound[7, 0] += skin / 2
    assert not nl.update(at_bound)[3] and nl.rebuilds == 1
    past = pos.copy()
    past[7, 0] += skin / 2 + 1e-9
    assert nl.update(past)[3] and nl.rebuilds == 2
    assert not nl.update(past)[3] and nl.rebuilds == 2


def _prop_validation_errors():
    with pytest.raises(ValueError, match="cutoff"):
        NeighborList(0.0, 0.1)
    with pytest.raises(ValueError, match="skin"):
        NeighborList(1.0, -0.1)
    with pytest.raises(ValueError, match="skin"):
        NeighborList(1.0, float("nan"))
    with pytest.raises(ValueError, match="cell"):
        NeighborList(1.0, 0.1, pbc=(True, True, True)).update(
            np.zeros((3, 3)))
    with pytest.raises(ValueError, match="open-boundary"):
        NeighborList(1.0, 0.1).update(np.zeros((3, 3)), cell=np.eye(3))
    with pytest.raises(RuntimeError, match="export_candidates"):
        NeighborList(1.0, 0.1).export_candidates()


def _generic_keep(d2, recv, send, ok, k):
    """The JAX package's generic (d², sender) lexsort cap on the `ok`
    entries: the documented total order, as a full-length mask."""
    ref = j_cap_neighbours(d2[ok], recv[ok], k, send[ok])
    full = np.zeros(len(d2), bool)
    full[np.flatnonzero(ok)[ref]] = True
    return full


def _prop_candidate_cap_ties():
    """`_CandidateCap.keep` and the port's `_cap_neighbours` select the
    JAX package's generic total order on tie-heavy inputs."""
    rng = np.random.RandomState(5)
    for trial in range(50):
        nseg = rng.randint(1, 20)
        recv = np.concatenate([np.full(rng.randint(1, 25), s)
                               for s in range(nseg)])
        send = np.concatenate(
            [np.sort(rng.choice(500, size=int((recv == s).sum()),
                                replace=False)) for s in range(nseg)])
        d2 = rng.choice([0.25, 1.0, 2.25, rng.rand()], size=len(recv))
        ok = rng.rand(len(recv)) < 0.8
        k = int(rng.randint(1, 6))
        want = _generic_keep(d2, recv, send, ok, k)
        np.testing.assert_array_equal(_CandidateCap(recv, k).keep(d2, ok),
                                      want, err_msg=str(trial))
        full = np.ones(len(recv), bool)
        np.testing.assert_array_equal(_cap_neighbours(d2, recv, k),
                                      _generic_keep(d2, recv, send, full, k))


def _prop_candidate_cap_skew_fallback():
    """One huge segment beside thousands of singletons takes the lexsort
    fallback, with the same selection (an all-filtered input included)."""
    rng = np.random.RandomState(6)
    recv = np.concatenate([np.zeros(40000, np.int64),
                           np.arange(1, 20001, dtype=np.int64)])
    send = np.concatenate([np.arange(40000), np.zeros(20000)])
    d2 = rng.rand(len(recv))
    ok = rng.rand(len(recv)) < 0.7
    cap = _CandidateCap(recv, 5)
    assert cap.mat is None and not cap.keep_all
    np.testing.assert_array_equal(cap.keep(d2, ok),
                                  _generic_keep(d2, recv, send, ok, 5))
    assert not cap.keep(d2, np.zeros(len(recv), bool)).any()


def _prop_cap_zero_keeps_nothing():
    rng = np.random.RandomState(7)
    recv = np.sort(rng.randint(0, 20, 300))
    d2 = rng.rand(300)
    assert not _cap_neighbours(d2, recv, 0).any()
    assert not _CandidateCap(recv, 0).keep(d2, np.ones(300, bool)).any()
    s, r = radius_graph(rng.rand(30, 3), 0.8, max_neighbours=0)
    assert len(s) == 0 and len(r) == 0


PROPERTIES = {
    "bruteforce_oracle": _prop_bruteforce_oracle,
    "rebuild_exactly_past_skin_half": _prop_rebuild_exactly_past_skin_half,
    "validation_errors": _prop_validation_errors,
    "candidate_cap_ties": _prop_candidate_cap_ties,
    "candidate_cap_skew_fallback": _prop_candidate_cap_skew_fallback,
    "cap_zero_keeps_nothing": _prop_cap_zero_keeps_nothing,
}


@pytest.mark.parametrize("prop", sorted(PROPERTIES))
def test_neighborlist_properties(prop):
    PROPERTIES[prop]()
