"""The dense PNA kernels' host-side pieces on the CPU (kernels/nbr.py):
the neighbour layout and its slot -> position map (`build_neighbor_layout`,
where the backward kernel writes each kept slot's dh), the order in which
the backward kernel's pass 2 sums those rows (the layout's: on the CPU the
plain VJP's dproj_j sums in it too), and the kernels' launch geometry
(`row_geometry`, laid out by csrc/slots.cuh). All bitwise or exact. The
kernels themselves run only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.kernels import nbr

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)


def _table(case):
    """(nbr [N, K] int32, mask [N, K] bool) of one layout case."""
    rng = np.random.RandomState(7)
    n, k = {"random": (40, 6), "empty_rows": (30, 5), "all_masked": (12, 4),
            "out_of_range": (25, 7), "k1": (33, 1), "hub": (60, 40)}[case]
    idx = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.3
    if case == "empty_rows":
        mask[::3] = False
    elif case == "all_masked":
        mask[:] = False
    elif case == "out_of_range":
        idx[rng.rand(n, k) < 0.2] = n + 2
        idx[rng.rand(n, k) < 0.1] = -1
    elif case == "hub":
        idx[:, 3] = 5              # node 5 named by every row
        mask[:, 3] = True
        mask[9] = True             # a row with all 40 slots kept
    return idx, mask


def _numpy_layout(idx, mask):
    """The reference: kept slots stable-sorted by neighbour id, the others
    after them in slot order; row_ptr by counting; positions inverted."""
    n, k = idx.shape
    flat, m = idx.reshape(-1), mask.reshape(-1)
    kept = m & (flat >= 0) & (flat < n)
    keys = np.where(kept, flat, n)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(flat[kept], minlength=n))]
    ).astype(np.int32)
    pos = np.full(n * k, -1, np.int32)
    pos[order[:kept.sum()]] = np.arange(kept.sum(), dtype=np.int32)
    return row_ptr, order, pos


@pytest.mark.parametrize("case", ["random", "empty_rows", "all_masked",
                                  "out_of_range", "k1", "hub"])
def test_neighbor_layout_and_slot_positions_match_numpy(case):
    """row_ptr, the slot order and the slot -> position map equal a numpy
    construction bit for bit; every kept slot's position points back at
    it, and the positions of the kept slots fill [0, row_ptr[N])."""
    idx, mask = _table(case)
    got = nbr.build_neighbor_layout(torch.from_numpy(idx),
                                    torch.from_numpy(mask))
    want = _numpy_layout(idx, mask)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    row_ptr, order, pos = (t.numpy() for t in got)
    kept = int(row_ptr[-1])
    assert np.array_equal(pos[order[:kept]], np.arange(kept))
    assert np.all(pos[order[kept:]] == -1)
    # on the CPU the Functions take the plain versions: no layout
    assert nbr.neighbor_layout(torch.from_numpy(idx),
                               torch.from_numpy(mask)) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "out_of_range", "hub"])
def test_layout_ordered_sum_of_slot_grads_is_the_plain_dproj_j(case, dtype):
    """The plain VJP's dproj_j equals, bit for bit, its own slot gradients
    (`nbr.slot_grads`) summed in float32 in the layout's order, the order
    in which the backward kernel's pass 2 streams them (the card test
    holds the kernel against the same sum): on the CPU the segment sum
    adds a node's slots in slot order, and the layout keeps that order
    within a node."""
    from tests.test_torch_cuda import _layout_ordered_sum
    idx, mask = _table(case)
    n, k = idx.shape
    f = 6
    rng = np.random.RandomState(5)
    pi, pj, *grads = (torch.from_numpy(rng.randn(n, f).astype(np.float32))
                      .to(dtype) for _ in range(6))
    tables = (torch.from_numpy(idx), torch.from_numpy(mask))
    _, mn, mx, _, _ = nbr.nbr_aggregate_plain(pi, pj, *tables)
    dh, _ = nbr.slot_grads(pi, pj, *tables, mn, mx, *grads)
    layout = nbr.build_neighbor_layout(*tables)
    got = _layout_ordered_sum(dh.reshape(n * k, f), layout, n)
    want = nbr.nbr_aggregate_vjp(pi, pj, *tables, mn, mx, *grads)[1]
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    assert got.abs().max() > 0


@pytest.mark.parametrize("k,f,vec,itemsize,stage", [
    (24, 200, 4, 4, False), (24, 200, 4, 4, True),      # the csce shapes
    (24, 200, 4, 2, False), (24, 200, 4, 2, True),
    (24, 13, 1, 4, True), (24, 13, 1, 2, True), (1, 200, 4, 4, True),
    (64, 200, 4, 4, True),                              # longer than a chunk
    (4, 4096, 4, 4, True), (8, 2048, 4, 2, False),      # one row a block
    (0, 200, 4, 4, False),
])
def test_row_geometry_fits_the_card(k, f, vec, itemsize, stage):
    """Whole warps a row, at most 1,024 threads a block; the backward
    stages a chunk of 1 to STAGE_SLOTS slots (all K at once where K fits),
    the forward none; the dynamic shared memory the kernels lay out
    (staging rounded to 16 bytes, then one list of K ints a row, two for
    the backward) within the card's 227 KB."""
    rows, tpr, chunk, smem = nbr.row_geometry(k, f, vec, itemsize, stage)
    assert tpr % 32 == 0 and tpr >= f // vec and tpr - f // vec < 32
    assert 1 <= rows <= 32 and rows * tpr <= 1024
    lists = rows * k * 4 * (2 if stage else 1)
    if not stage:
        assert chunk == 0 and smem == lists
    else:
        assert 1 <= chunk <= nbr.STAGE_SLOTS
        if 1 <= k <= nbr.STAGE_SLOTS:
            assert chunk == k
        assert smem == -(-(rows * chunk * f * itemsize) // 16) * 16 + lists
    assert smem <= 232448


def test_row_geometry_refuses_what_cannot_launch():
    with pytest.raises(ValueError, match="1024 threads"):
        nbr.row_geometry(8, 4100 * 4, 4, 4)
    with pytest.raises(ValueError, match="shared memory"):
        nbr.row_geometry(40000, 200, 4, 4, stage=True)
    with pytest.raises(ValueError, match="shared memory"):
        nbr.row_geometry(70000, 200, 4, 4)
