"""The edge-list PNA kernels' host-side pieces on the CPU
(kernels/fused_mp.py): the two CSR layouts of the edges and the edge ->
position map between them (`edge_positions`, the row of the backward
kernel's dh buffer each receiver-sorted edge fills), the orders in which
the backward kernel sums the per-edge gradients (`edge_grads`: dproj_i in
the receiver-sorted layout's order, dproj_j in the sender-sorted one's; on
the CPU the plain VJP sums in those orders too), and the launch geometry
of the backward's pass 1 and of the forward. All bitwise or exact. The
counterpart of tests/test_torch_nbr_layout.py; the kernels themselves run
only on the card (tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

from hydragnn_tpu_torch.graphs.synthetic import tie_rich_edge_case
from hydragnn_tpu_torch.kernels import fused_mp, nbr

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

CASES = ["random", "masked_out_of_range", "hubs", "no_kept_edge",
         "no_edges", "tie_rich"]


def _edges(case):
    """(senders, receivers int32, edge_mask bool, n) of one layout case:
    random edges; masked edges and ids outside [0, N); a receiver and a
    sender with more edges than the backward stages at once
    (`nbr.STAGE_SLOTS`); a graph whose edges are all masked; no edges;
    the tie-rich dyadic case of graphs/synthetic.py."""
    rng = np.random.RandomState(3)
    if case == "tie_rich":
        _, _, send, recv, em = tie_rich_edge_case(4, n=30, f=6)
        return send, recv, em, 30
    n, e = {"random": (40, 300), "masked_out_of_range": (25, 200),
            "hubs": (60, 400), "no_kept_edge": (12, 50),
            "no_edges": (9, 0)}[case]
    send = rng.randint(0, n, e).astype(np.int32)
    recv = rng.randint(0, n, e).astype(np.int32)
    em = rng.rand(e) > 0.2
    if case == "masked_out_of_range":
        em = rng.rand(e) > 0.5
        recv[rng.rand(e) < 0.15] = n + 2
        send[rng.rand(e) < 0.1] = -1
        recv[rng.rand(e) < 0.05] = -3
    elif case == "hubs":
        recv[:100] = 5             # a receiver of ~80 kept edges
        send[150:270] = 7          # a sender of ~96
        em[:100] = em[150:270] = True
        em[:3] = False
    elif case == "no_kept_edge":
        em[:] = False
    return send, recv, em, n


def _numpy_csr(keys_of, other, kept, n):
    """(row_ptr, other ids in key order, edge order): the kept edges
    stable-sorted by `keys_of`, the dropped ones after them."""
    keys = np.where(kept, keys_of, n)
    order = np.argsort(keys, kind="stable").astype(np.int32)
    row_ptr = np.concatenate(
        [[0], np.cumsum(np.bincount(keys_of[kept], minlength=n))]
    ).astype(np.int32)
    return row_ptr, other[order], order


def _numpy_positions(send, recv, em, n):
    """The reference: the receiver- and sender-sorted layouts and, for
    each receiver-sorted position r, the sender-sorted position of the
    same edge (-1 for the dropped edges)."""
    kept = (em & (send >= 0) & (send < n) & (recv >= 0) & (recv < n))
    by_recv = _numpy_csr(recv, send, kept, n)
    by_send = _numpy_csr(send, recv, kept, n)
    where_t = np.empty(send.size, np.int32)
    where_t[by_send[2]] = np.arange(send.size, dtype=np.int32)
    pos = np.where(np.arange(send.size) < kept.sum(), where_t[by_recv[2]],
                   -1).astype(np.int32)
    return by_recv, by_send, pos


@pytest.mark.parametrize("case", CASES)
def test_edge_positions_match_numpy(case):
    """Both layouts and the edge -> position map equal a numpy
    construction bit for bit; each kept edge's position names the same
    edge in the sender-sorted layout, the kept edges' positions fill [0,
    kept) once each, and the dropped edges' are -1."""
    send, recv, em, n = _edges(case)
    t = [torch.from_numpy(a) for a in (send, recv, em)]
    layout = fused_mp.csr_layout(t[0], t[1], t[2], n)
    layout_t = fused_mp.csr_layout(t[1], t[0], t[2], n)
    pos = fused_mp.edge_positions(layout, layout_t)
    want_r, want_s, want_pos = _numpy_positions(send, recv, em, n)
    for got, want in zip((*layout, *layout_t, pos),
                         (*want_r, *want_s, want_pos)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    kept = int(layout[0][-1])
    assert kept == int(layout_t[0][-1])
    pos = pos.numpy()
    assert np.array_equal(layout_t[2].numpy()[pos[:kept]],
                          layout[2].numpy()[:kept])
    assert np.array_equal(np.sort(pos[:kept]), np.arange(kept))
    assert np.all(pos[kept:] == -1)
    if case == "hubs":
        spans = [np.diff(lay[0].numpy()).max() for lay in (layout, layout_t)]
        assert min(spans) > 2 * nbr.STAGE_SLOTS
    if case in ("no_kept_edge", "no_edges"):
        assert kept == 0
    # on the CPU the Functions take the plain versions: no layouts
    assert fused_mp.edge_layout(*t, n) is None
    assert fused_mp.edge_positions(None, None) is None


def _layout_sum(dh, row_ptr, order, n):
    """The float32 sum, in the layout's order, of the rows of dh [E, F]
    that each node's range [row_ptr[j], row_ptr[j + 1]) names (edges
    order[.]), stored in dh's dtype: the order of the backward kernel's
    passes (numpy, row after row)."""
    row_ptr, order = row_ptr.numpy(), order.numpy()
    rows = dh.float().numpy()
    out = np.zeros((n, dh.shape[1]), np.float32)
    for j in range(n):
        for q in range(row_ptr[j], row_ptr[j + 1]):
            out[j] = out[j] + rows[order[q]]
    return torch.from_numpy(out).to(dh.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "masked_out_of_range", "hubs",
                                  "tie_rich"])
def test_layout_ordered_sums_of_edge_grads_are_the_plain_vjp(case, dtype):
    """The plain VJP's dproj_i and dproj_j equal, bit for bit, its own
    per-edge gradients (`fused_mp.edge_grads`) summed in float32 in the
    receiver-sorted and the sender-sorted layout's order, the orders in
    which the backward kernel's pass 1 and pass 2 sum them (the card test
    holds the kernel against the same sums): on the CPU the segment sums
    add a node's edges in edge order, and a stable layout keeps that
    order within a node. Dropped edges carry dh = 0."""
    send, recv, em, n = _edges(case)
    f = 6
    rng = np.random.RandomState(5)
    if case == "tie_rich":
        pi, pj, send, recv, em = tie_rich_edge_case(4, n=n, f=f,
                                                    bf16_exact=True)
        pi, pj = (torch.from_numpy(a).to(dtype) for a in (pi, pj))
        grads = [torch.from_numpy(rng.randint(-4, 5, (n, f)) / 8).to(dtype)
                 for _ in range(4)]
    else:
        pi, pj, *grads = (torch.from_numpy(rng.randn(n, f).astype(
            np.float32)).to(dtype) for _ in range(6))
    tables = tuple(torch.from_numpy(a) for a in (send, recv, em)) + (n,)
    acc = fused_mp.pna_edge_accumulators_plain(pi, pj, *tables)
    dh, _, _ = fused_mp.edge_grads(pi, pj, *tables, acc[3], acc[4], *grads)
    assert dh.dtype == dtype and dh.shape == (send.size, f)
    keep = fused_mp._kept_edges(*tables)
    assert not dh[~keep].any()
    layout = fused_mp.csr_layout(*tables)
    layout_t = fused_mp.csr_layout(tables[1], tables[0], tables[2], n)
    want = fused_mp.pna_edge_vjp(pi, pj, *tables, acc[3], acc[4], *grads)
    for got, w in zip((_layout_sum(dh, layout[0], layout[2], n),
                       _layout_sum(dh, layout_t[0], layout_t[2], n)), want):
        assert got.dtype == w.dtype == dtype
        assert torch.equal(got, w)
        assert got.abs().max() > 0


@pytest.mark.parametrize("f,vec,itemsize", [
    (200, 4, 4), (200, 4, 2),                   # the csce shapes
    (13, 1, 4), (13, 1, 2), (32, 4, 4), (6, 1, 2),
    (2048, 4, 4), (4096, 4, 2),                 # one row a block, > 48 KB
])
def test_edge_backward_geometry_fits_the_card(f, vec, itemsize):
    """The edge-list backward's pass 1 runs on whole-warp rows, at most
    1,024 threads a block, stages STAGE_SLOTS edges of a receiver at once
    (fewer only where the shared memory runs out) and keeps no slot
    lists: its dynamic shared memory is the staging area alone, within
    the card's 227 KB."""
    rows, tpr, chunk, smem = fused_mp.edge_geometry(f, vec, itemsize)
    assert tpr % 32 == 0 and tpr >= f // vec and tpr - f // vec < 32
    assert 1 <= rows <= 32 and rows * tpr <= 1024
    assert 1 <= chunk <= nbr.STAGE_SLOTS
    assert smem == -(-(rows * chunk * f * itemsize) // 16) * 16
    assert smem <= 232448
    if f * itemsize <= 8192:
        assert chunk == nbr.STAGE_SLOTS
    if f == 2048:
        assert smem > 48 * 1024     # the kernel's shared-memory opt-in
    with pytest.raises(ValueError, match="1024 threads"):
        fused_mp.edge_geometry(4100 * vec, vec, itemsize)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_geometry_flat_or_whole_warp_rows(dtype, monkeypatch):
    """The forward's receivers a block: FORWARD_ROWS of the dtype (0 is
    the flat launch), at most a block of 1,024 threads' worth, and flat
    where a row would exceed 1,024 threads."""
    for rows in (0, 1, 2, 8, 40):
        monkeypatch.setitem(fused_mp.FORWARD_ROWS, dtype, rows)
        assert fused_mp.forward_geometry(200, 4, dtype) == min(rows, 16)
        assert fused_mp.forward_geometry(13, 1, dtype) == min(rows, 32)
        assert fused_mp.forward_geometry(4096, 4, dtype) == min(rows, 1)
        assert fused_mp.forward_geometry(1030, 1, dtype) == 0


def test_conv_args_carry_no_layouts_on_the_cpu():
    """PNAStack.conv_args hands every layer the layouts and the edge ->
    position map once a forward; on the CPU all are None (the plain
    versions need none), and without gradients the backward's are not
    built."""
    from hydragnn_tpu_torch.graphs.batch import collate
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
    from hydragnn_tpu_torch.models.stacks import PNAStack
    batch = collate(synthetic_molecules(3, seed=0), n_node=128, n_edge=2048,
                    n_graph=4)
    with torch.enable_grad():
        cargs = PNAStack.conv_args(None, batch)
    assert {"edge_layout", "edge_layout_t", "edge_pos"} <= set(cargs)
    assert all(cargs[k] is None for k in ("edge_layout", "edge_layout_t",
                                          "edge_pos"))
    with torch.no_grad():
        cargs = PNAStack.conv_args(None, batch)
    assert "edge_pos" not in cargs and cargs["edge_layout"] is None
