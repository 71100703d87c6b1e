"""The port's CUDA kernels against their plain PyTorch versions on the
card. These tests import no JAX (the machine with the card has none) and
skip without a CUDA device; run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX). Bounds as in
tests/test_torch_kernels.py: min/max/count exact, sums rtol/atol 2e-5.
The autograd Functions (`segment_sum`'s, `filter_scatter`'s,
`gather_rows`', `nbr_aggregate`'s and `pna_edge_accumulators`') are held
against autograd through the plain versions on the same card: a gather
or a product of the same two numbers is exact, a sum (dh, a gather's
gradient) within the sums' rtol/atol 2e-5, and the PNA backwards exactly
on the tie-rich dyadic cases of graphs/synthetic.py.

The bf16 instantiations are held against the plain versions in bf16:
min, max, counts and degrees bitwise; sums (and nbr_aggregate's mean and
std, a few rounded ops past its sums) within `BF16_ULPS` bf16 ulps of the
larger magnitude (at least 2^-10; the two float32 sums differ in order
only, so they round to the same bf16 value or a neighbour); the
bf16-exact tie-rich dyadic cases bitwise.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from hydragnn_tpu_torch import kernels as tk
from hydragnn_tpu_torch.kernels import fused_mp, nbr, segment

SUM_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 ulps: a sum; nbr_aggregate's mean and std, past its sums
BF16_ULPS = {"sum": 1, "mean": 2, "std": 2}


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _nbr_inputs(seed, n, k, f):
    rng = np.random.RandomState(seed)
    pi = rng.randn(n, f).astype(np.float32)
    pj = rng.randn(n, f).astype(np.float32)
    idx = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.3
    mask[5] = False
    return pi, pj, idx, mask


def _edge_inputs(seed, n, e, f):
    rng = np.random.RandomState(seed)
    pi = rng.randn(n, f).astype(np.float32)
    pj = rng.randn(n, f).astype(np.float32)
    send = rng.randint(0, n, e).astype(np.int32)
    recv = rng.randint(0, n, e).astype(np.int32)
    recv[recv == 7] = 8
    emask = rng.rand(e) > 0.2
    recv[:3] = n + 5
    return pi, pj, send, recv, emask


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(cuda_device):
    """On the card each wrapper launches its CUDA kernel; it must agree
    with its plain version (exact for min/max/count, SUM_TOL for sums)."""
    dev = cuda_device
    pi, pj, idx, mask = _nbr_inputs(5, n=300, k=16, f=200)
    args = [_t(a).to(dev) for a in (pi, pj, idx, mask)]
    for name, g, w in zip(("mean", "min", "max", "std", "deg"),
                          nbr.nbr_aggregate(*args),
                          nbr.nbr_aggregate_plain(*args)):
        if name in ("min", "max", "deg"):
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, **SUM_TOL)
    pi, pj, send, recv, emask = _edge_inputs(5, n=300, e=4000, f=200)
    args = [_t(a).to(dev) for a in (pi, pj, send, recv, emask)] + [300]
    for name, g, w in zip(("s", "sq", "cnt", "min", "max"),
                          fused_mp.pna_edge_accumulators(*args),
                          fused_mp.pna_edge_accumulators_plain(*args)):
        if name in ("cnt", "min", "max"):
            assert torch.equal(g, w), name
        else:
            torch.testing.assert_close(g, w, **SUM_TOL)
    data = _t(pi).to(dev)
    ids = _t(np.sort(np.random.RandomState(0).randint(0, 40, 300))
             .astype(np.int32)).to(dev)
    torch.testing.assert_close(
        segment.segment_sum(data, ids, 40, indices_are_sorted=True),
        segment.segment_sum_plain(data, ids, 40), **SUM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [200, 13])
def test_kernels_count_launches_and_take_odd_widths(cuda_device, f):
    """F = 13 runs the scalar (non-float4) path of every kernel."""
    tk.reset_launch_counts()
    pi, pj, idx, mask = _nbr_inputs(6, n=64, k=8, f=f)
    args = [_t(a).to(cuda_device) for a in (pi, pj, idx, mask)]
    for g, w in zip(nbr.nbr_aggregate(*args), nbr.nbr_aggregate_plain(*args)):
        torch.testing.assert_close(g, w, **SUM_TOL)
    pi, pj, send, recv, emask = _edge_inputs(6, n=64, e=500, f=f)
    args = [_t(a).to(cuda_device) for a in (pi, pj, send, recv, emask)] + [64]
    for g, w in zip(fused_mp.pna_edge_accumulators(*args),
                    fused_mp.pna_edge_accumulators_plain(*args)):
        torch.testing.assert_close(g, w, **SUM_TOL)
    data = _t(pi).to(cuda_device)
    ids = _t(recv).to(cuda_device)
    torch.testing.assert_close(segment.segment_sum(data, ids[:64], 64),
                               segment.segment_sum_plain(data, ids[:64], 64),
                               **SUM_TOL)
    assert tk.launch_counts() == {"segment_sum": 1, "nbr_aggregate": 1,
                                  "pna_edge_aggregate": 1,
                                  "filter_scatter": 0,
                                  "filter_scatter_backward": 0,
                                  "nbr_aggregate_backward": 0,
                                  "pna_edge_aggregate_backward": 0,
                                  "nbr_aggregate_bf16": 0,
                                  "pna_edge_aggregate_bf16": 0,
                                  "filter_scatter_bf16": 0,
                                  "filter_scatter_backward_bf16": 0,
                                  "nbr_aggregate_backward_bf16": 0,
                                  "pna_edge_aggregate_backward_bf16": 0}
    with pytest.raises(TypeError):
        segment.segment_sum(data.double(), ids[:64], 64)


def _filter_inputs(seed, n, e, f, dev):
    rng = np.random.RandomState(seed)
    h = rng.randn(n, f).astype(np.float32)
    w = rng.randn(e, f).astype(np.float32)
    send = rng.randint(0, n, e).astype(np.int32)
    recv = rng.randint(0, n, e).astype(np.int32)
    recv[recv == 7] = 8            # node 7: no in-edge
    send[send == 9] = 10           # node 9: no out-edge (dh row 0)
    emask = rng.rand(e) > 0.2
    recv[:3] = n + 5               # out of range: dropped
    send[3:5] = -2
    return [_t(a).to(dev) for a in (h, w, send, recv, emask)]


@pytest.mark.cuda
@pytest.mark.parametrize("f", [32, 13])
def test_filter_scatter_forward_and_backward_on_the_card(cuda_device, f):
    """Kernel vs plain version, forward and the Function's backward (dh by
    the kernel on the transposed layout, dw a gather-multiply) vs
    autograd through the plain version; F = 13 runs the scalar path and
    E = 997 is a multiple of no block size."""
    n, e = 300, 997
    h, w, send, recv, emask = _filter_inputs(7, n, e, f, cuda_device)
    g = torch.randn(n, f, device=cuda_device)
    tk.reset_launch_counts()
    grads = []
    for fn in (fused_mp.filter_scatter, fused_mp.filter_scatter_plain):
        th = h.clone().requires_grad_(True)
        tw = w.clone().requires_grad_(True)
        out = fn(th, tw, send, recv, emask, n)
        grads.append((out,) + torch.autograd.grad((out * g).sum(), (th, tw)))
    (out, dh, dw), (p_out, p_dh, p_dw) = grads
    torch.testing.assert_close(out, p_out, **SUM_TOL)
    torch.testing.assert_close(dh, p_dh, **SUM_TOL)
    assert torch.equal(dw, p_dw)
    assert not out[7].any() and not dh[9].any()
    counts = tk.launch_counts()
    assert counts["filter_scatter"] == 1
    assert counts["filter_scatter_backward"] == 1
    with pytest.raises(TypeError):
        fused_mp.filter_scatter(h.double(), w.double(), send, recv, emask, n)


@pytest.mark.cuda
def test_functions_match_plain_autograd_to_second_order(cuda_device):
    """gradcheck-style, in float32: each Function's vector-Jacobian
    product against autograd through its plain version on the same card,
    and the filter-scatter's gradient differentiated once more (the force
    loss of the training slice)."""
    dev = cuda_device
    n, e, f = 200, 1500, 32
    h, w, send, recv, emask = _filter_inputs(8, n, e, f, dev)
    g, k = torch.randn(n, f, device=dev), torch.randn(n, f, device=dev)
    second = []
    for fn in (fused_mp.filter_scatter, fused_mp.filter_scatter_plain):
        th = h.clone().requires_grad_(True)
        tw = w.clone().requires_grad_(True)
        y = fn(th, tw, send, recv, emask, n)
        (dh,) = torch.autograd.grad((y * g).sum(), th, create_graph=True)
        second.append(torch.autograd.grad((dh * k).sum(), tw)[0])
    torch.testing.assert_close(second[0], second[1], **SUM_TOL)

    ids = recv.clone()
    data = torch.randn(e, f, device=dev)
    gs = torch.randn(n, f, device=dev)
    got = []
    for fn in (segment.segment_sum, segment.segment_sum_plain):
        td = data.clone().requires_grad_(True)
        got.append(torch.autograd.grad((fn(td, ids, n) * gs).sum(), td)[0])
    assert torch.equal(got[0], got[1])

    pos = torch.randn(n, 3, device=dev)
    idx = torch.randint(0, n, (e,), device=dev, dtype=torch.int32)
    ge = torch.randn(e, 3, device=dev)
    got = []
    for fn in (segment.gather_rows, lambda x, i: x.index_select(0, i)):
        tp = pos.clone().requires_grad_(True)
        got.append(torch.autograd.grad((fn(tp, idx) * ge).sum(), tp)[0])
    torch.testing.assert_close(got[0], got[1], **SUM_TOL)


def _segment_case(seed, sizes, f, dev):
    """Data rows and sorted ids for segments of the given sizes (in
    order), plus 3 rows of id -1 in front and 5 of id len(sizes) behind.
    The data are multiples of 2^-8 below 8 in magnitude, so every sum of
    up to 2^13 rows is exact in float32 whatever the order of the adds,
    and the kernel must equal the plain version (an atomic scatter on the
    card) bitwise."""
    rng = np.random.RandomState(seed)
    ids = np.concatenate([np.full(3, -1)] + [np.full(s, k) for k, s in
                                              enumerate(sizes)]
                         + [np.full(5, len(sizes))]).astype(np.int32)
    data = np.round(np.clip(rng.randn(ids.shape[0], f), -7, 7) * 256) / 256
    data = data.astype(np.float32)
    return _t(data).to(dev), _t(ids).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 13, 200])
def test_segment_sum_chunks_empty_and_out_of_range(cuda_device, f):
    """Segments of 0, 1, a chunk and one row, and many chunks (the last
    longer than half of E), with sorted int32 and int64 ids and shuffled
    ids, against the plain version (exact data: bitwise); empty segments
    are 0 and ids out of range add nothing."""
    c = segment.chunk_rows(f)
    sizes = [0, 1, c, c + 1, 0, 7 * c + 3, 2, 0, 12 * c + 5]
    n = len(sizes)
    data, ids = _segment_case(1, sizes, f, cuda_device)
    assert sizes[-1] > ids.shape[0] // 2
    want = segment.segment_sum_plain(data, ids, n)
    got = segment.segment_sum(data, ids, n, indices_are_sorted=True)
    assert torch.equal(got, want)
    assert not got[0].any() and not got[4].any() and not got[7].any()
    shuffle = torch.randperm(ids.shape[0], device=cuda_device)
    got = segment.segment_sum(data[shuffle].contiguous(), ids[shuffle], n)
    assert torch.equal(got, want)
    got = segment.segment_sum(data, ids.long(), n, indices_are_sorted=True)
    assert torch.equal(got, want)
    rp = segment.sorted_row_ptr(ids, n)
    assert torch.equal(rp.cpu(), segment.sorted_row_ptr(ids.cpu(), n))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 3, 200])
def test_segment_sum_is_position_independent(cuda_device, f):
    """One segment's sum is bitwise the same wherever it sits in the
    batch and whatever its neighbours: shifted through the sorted rows by
    neighbours of other sizes, and interleaved with them (unsorted ids,
    the segment's own rows kept in their order)."""
    c = segment.chunk_rows(f)
    rng = np.random.RandomState(2)
    for length in (5, c, 3 * c + 7, 40 * c + 1):
        rows = _t(rng.randn(length, f).astype(np.float32)).to(cuda_device)
        results = []
        for before in (0, 1, c - 1, 5 * c + 3):
            other = _t(rng.randn(before + 9, f).astype(np.float32)).to(
                cuda_device)
            data = torch.cat([other[:before], rows, other[before:]])
            ids = torch.cat([torch.zeros(before), torch.ones(length),
                             torch.full((9,), 2.0)]).to(cuda_device)
            ids = ids.to(torch.int32)
            results.append(segment.segment_sum(data, ids, 3,
                                               indices_are_sorted=True)[1])
            # a random interleaving that keeps each segment's row order
            slots = np.sort(rng.choice(data.shape[0], length, replace=False))
            rest = np.setdiff1d(np.arange(data.shape[0]), slots)
            order = np.empty(data.shape[0], np.int64)
            order[slots] = np.arange(before, before + length)
            order[rest] = rng.permutation(np.concatenate([
                np.arange(before), np.arange(before + length,
                                             data.shape[0])]))
            order = _t(order).to(cuda_device)
            results.append(segment.segment_sum(data[order].contiguous(),
                                               ids[order], 3)[1])
        for r in results[1:]:
            assert torch.equal(r, results[0]), length


@pytest.mark.cuda
def test_segment_sum_layout_reuse_matches_fresh_sort(cuda_device):
    """The gathers' backward over a filter layout (masked padding edges,
    self-loops on the padding node, left out) against the fresh sort over
    every edge: bitwise on every real node, for both layouts, and
    through edge_vectors' gradient."""
    from hydragnn_tpu_torch.ops.geometry import edge_vectors
    dev = cuda_device
    rng = np.random.RandomState(3)
    n, e_real, e_pad = 500, 9000, 700
    send = rng.randint(0, n - 1, e_real + e_pad).astype(np.int32)
    recv = rng.randint(0, n - 1, e_real + e_pad).astype(np.int32)
    send[e_real:] = recv[e_real:] = n - 1
    send[:1200] = 17                 # a node of many chunks' worth of edges
    mask = np.arange(e_real + e_pad) < e_real
    send, recv, mask = (_t(a).to(dev) for a in (send, recv, mask))
    layouts = fused_mp.filter_layouts(send, recv, mask, n)
    by_recv, by_send = fused_mp.segment_layouts(layouts)
    g = torch.randn(e_real + e_pad, 3, device=dev)
    for ids, lay in ((send, by_send), (recv, by_recv)):
        fresh = segment.segment_sum(g, ids, n)
        reuse = segment.segment_sum(g, ids, n, layout=lay)
        assert torch.equal(reuse[:n - 1], fresh[:n - 1])
    pos = torch.randn(n, 3, device=dev)
    grads = []
    for lay_s, lay_r in ((None, None), (by_send, by_recv)):
        tp = pos.clone().requires_grad_(True)
        vec, length = edge_vectors(tp, send, recv, send_layout=lay_s,
                                   recv_layout=lay_r)
        weight = torch.where(mask, torch.randn(e_real + e_pad, device=dev,
                             generator=torch.Generator(dev).manual_seed(0)),
                             torch.zeros((), device=dev))
        grads.append(torch.autograd.grad((length * weight).sum(), tp)[0])
    assert torch.equal(grads[0][:n - 1], grads[1][:n - 1])


@pytest.mark.cuda
def test_segment_sum_layout_backward_leaves_out_dropped_rows(cuda_device):
    """Autograd through segment_sum(layout=...) against autograd through
    the plain sum of the rows the layout keeps: g[id] on those rows and 0
    on the masked edges it drops, exactly (a gather)."""
    dev = cuda_device
    rng = np.random.RandomState(5)
    n, e = 300, 6000
    send = _t(rng.randint(0, n, e).astype(np.int32)).to(dev)
    recv = _t(rng.randint(0, n, e).astype(np.int32)).to(dev)
    mask = _t(rng.rand(e) > 0.3).to(dev)
    by_recv, _ = fused_mp.segment_layouts(
        fused_mp.filter_layouts(send, recv, mask, n))
    data = torch.randn(e, 3, device=dev)
    g = torch.randn(n, 3, device=dev)
    grads = []
    for fn in (lambda d: segment.segment_sum(d, recv, n, layout=by_recv),
               lambda d: segment.segment_sum_plain(
                   torch.where(mask[:, None], d, torch.zeros_like(d)), recv,
                   n)):
        td = data.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((fn(td) * g).sum(), td)[0])
    assert torch.equal(grads[0], grads[1])
    assert not grads[0][~mask].any() and grads[0][mask].any()


@pytest.mark.cuda
def test_segment_sum_on_concurrent_streams(cuda_device):
    """Segment sums of hundreds of chunks each (about 80 MB of rows a
    call, so that the two streams' launches overlap) on two streams at
    once: each stream has its own tickets, and every result equals the
    plain version bitwise."""
    dev = cuda_device
    c = segment.chunk_rows(200)
    sizes = [0, 3, 8000, 0, 7001, c + 1] + [6000] * 15
    n = len(sizes)
    data, ids = _segment_case(6, sizes, 200, dev)
    want = segment.segment_sum_plain(data, ids, n)
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    outs = []
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    for _ in range(30):
        for s in streams:
            with torch.cuda.stream(s):
                outs.append(segment.segment_sum(data, ids, n,
                                                indices_are_sorted=True))
    torch.cuda.synchronize(dev)
    for out in outs:
        assert torch.equal(out, want)
    t0, t1 = (segment._tickets[(data.device, s.cuda_stream)]
              for s in streams)
    assert t0.data_ptr() != t1.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("f", [32, 13, 1028, 1030])
def test_filter_scatter_long_and_empty_receivers(cuda_device, f):
    """Receivers with 0 and 1 edges, and one with more edges than edge
    lanes x staging tile (4 x 1024), forward and backward against the
    plain version; F = 1028 and 1030 have more feature groups than a
    block has threads (passes over the features, float4 and scalar). h and w are multiples of 2^-3 in [-2, 2], so every
    product and every sum of up to 5000 of them is exact in float32 in
    any order: out, dh and dw must equal the plain version bitwise."""
    dev = cuda_device
    rng = np.random.RandomState(4)
    n, e = 64, 9000
    recv = rng.randint(2, n, e).astype(np.int32)
    recv[:5000] = 40                 # 5000 in-edges
    recv[5000] = 1                   # receiver 1: one edge; 0: none
    send = rng.randint(0, n, e).astype(np.int32)
    send[:4500] = 3                  # sender 3: 4500 out-edges (dh)
    mask = rng.rand(e) > 0.1
    mask[5000] = True
    h = (rng.randint(-16, 17, (n, f)) / 8).astype(np.float32)
    w = (rng.randint(-16, 17, (e, f)) / 8).astype(np.float32)
    g = (rng.randint(-16, 17, (n, f)) / 8).astype(np.float32)
    h, w, g, send, recv, mask = (_t(a).to(dev)
                                 for a in (h, w, g, send, recv, mask))
    grads = []
    for fn in (fused_mp.filter_scatter, fused_mp.filter_scatter_plain):
        th = h.clone().requires_grad_(True)
        tw = w.clone().requires_grad_(True)
        out = fn(th, tw, send, recv, mask, n)
        grads.append((out,) + torch.autograd.grad((out * g).sum(), (th, tw)))
    (out, dh, dw), (p_out, p_dh, p_dw) = grads
    assert torch.equal(out, p_out) and torch.equal(dh, p_dh)
    assert torch.equal(dw, p_dw)
    assert not out[0].any() and out[1].any()


def _pna_backward_pair(kind, args, grads, dev):
    """(Function's, plain autograd's) (dproj_i, dproj_j) on the card for
    the cotangents `grads` of (mean, min, max, std) (dense) or (s, sq,
    min, max) (edge list)."""
    out = []
    for plain in (False, True):
        pi, pj = (args[0].clone().requires_grad_(True),
                  args[1].clone().requires_grad_(True))
        if kind == "dense":
            fn = nbr.nbr_aggregate_plain if plain else nbr.nbr_aggregate
            res = fn(pi, pj, *args[2:])[:4]
        else:
            fn = (fused_mp.pna_edge_accumulators_plain if plain
                  else fused_mp.pna_edge_accumulators)
            acc = fn(pi, pj, *args[2:])
            res = (acc[0], acc[1], acc[3], acc[4])
        loss = sum((r * g).sum() for r, g in zip(res, grads))
        out.append(torch.autograd.grad(loss, (pi, pj)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "edge"])
@pytest.mark.parametrize("f", [200, 13])
def test_pna_backward_functions_match_plain_autograd(cuda_device, kind, f):
    """The two PNA Functions' backwards (the kernels of
    csrc/pna_backward.cu, on CSR layouts) against autograd through the
    plain versions on the card: random data within SUM_TOL, the tie-rich
    dyadic case (no std cotangent) bitwise; each backward call counts its
    two kernel launches and runs no segment sum."""
    from hydragnn_tpu_torch.graphs.synthetic import (tie_rich_edge_case,
                                                     tie_rich_neighbor_case)
    dev = cuda_device
    rng = np.random.RandomState(f)
    if kind == "dense":
        pi, pj, idx, mask = _nbr_inputs(9, n=300, k=16, f=f)
        cases = [([pi, pj, idx, mask], False),
                 (list(tie_rich_neighbor_case(2, n=60, f=f)), True)]
    else:
        pi, pj, send, recv, emask = _edge_inputs(9, n=300, e=4000, f=f)
        cases = [([pi, pj, send, recv, emask], False),
                 (list(tie_rich_edge_case(2, n=60, f=f)), True)]
    for arrays, dyadic in cases:
        args = [_t(a).to(dev) for a in arrays]
        if kind == "edge":
            args.append(args[0].shape[0])
        n = args[0].shape[0]
        if dyadic:
            grads = [_t(rng.randint(-4, 5, (n, f)) / 8).float().to(dev)
                     for _ in range(3)]
            grads.insert(3 if kind == "dense" else 1,
                         torch.zeros(n, f, device=dev))
        else:
            grads = [torch.randn(n, f, device=dev) for _ in range(4)]
        tk.reset_launch_counts()
        (got_i, got_j), (want_i, want_j) = _pna_backward_pair(kind, args,
                                                              grads, dev)
        counts = tk.launch_counts()
        name = "nbr_aggregate" if kind == "dense" else "pna_edge_aggregate"
        assert counts[f"{name}_backward"] == 2 and counts[name] == 1
        assert counts["segment_sum"] == 0
        if dyadic:
            assert torch.equal(got_i, want_i) and torch.equal(got_j, want_j)
        else:
            torch.testing.assert_close(got_i, want_i, **SUM_TOL)
            torch.testing.assert_close(got_j, want_j, **SUM_TOL)
        assert got_i.abs().max() > 0 and got_j.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False])
def test_pna_conv_gradient_on_the_card_equals_the_cpu(cuda_device, dense):
    """The regression behind the PNA Functions: through ctypes alone the
    aggregation's outputs had no graph on the card, so pre_i / pre_j got
    no gradient from it (None) while the step still ran. Every parameter
    gradient of a PNAConv on the card now equals the CPU's (rtol 1e-4,
    atol 1e-5, the forward's bound), pre_i's and pre_j's nonzero."""
    from hydragnn_tpu_torch.graphs.batch import (collate,
                                                 with_neighbor_format)
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
    from hydragnn_tpu_torch.models.convs import PNAConv
    from hydragnn_tpu_torch.models.stacks import PNAStack
    samples = synthetic_molecules(16, seed=3, min_atoms=5, max_atoms=30)
    batch = collate(samples)
    if dense:
        batch = with_neighbor_format(batch)
    torch.manual_seed(0)
    conv = PNAConv(12, 24, deg_hist=[1, 4, 6, 3, 1])
    x = torch.randn(batch.num_nodes, 12)
    # real nodes only, as a model's loss reads them: the padding node's
    # attenuation scaler divides by log(1), so its outputs are ~1e5
    g = torch.randn(batch.num_nodes, 24) * batch.node_mask[:, None]
    grads = []
    for dev in ("cpu", cuda_device):
        c = conv.to(dev)
        c.zero_grad()
        b = batch.to(dev)
        cargs = PNAStack.conv_args(None, b)
        out, _ = c(x.to(dev), b.pos, b, cargs)
        (out * g.to(dev)).sum().backward()
        grads.append({k: p.grad.detach().cpu().clone()
                      for k, p in c.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-4,
                                   atol=1e-5)
    assert grads[1]["pre_i.weight"].abs().max() > 0
    assert grads[1]["pre_j.weight"].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("model_kind", ["pna_dense", "pna_edge", "schnet",
                                        "schnet_dense"])
def test_train_step_repeats_bitwise_on_the_card(cuda_device, model_kind):
    """Two models from the same seed, two train steps each on the same
    batch (PNA on both layouts; LJ SchNet's energy-force step on both,
    whose force loss differentiates the kernels' backwards again): the
    losses and every parameter and running statistic afterwards are
    bitwise equal. No atomic float scatter runs on these paths."""
    import copy
    import json
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                     synthetic_molecules)
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train import optimizer as topt
    from hydragnn_tpu_torch.train import train_step as tstep
    if model_kind.startswith("schnet"):
        path = "examples/LennardJones/LJ.json"
        data = lj_configurations(40, seed=1)
    else:
        path = "examples/csce/csce_gap.json"
        data = synthetic_molecules(40, seed=1)
    with open(path) as fh:
        cfg = json.load(fh)
    dense = model_kind.endswith("dense")
    cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
    cfg["NeuralNetwork"]["Training"]["batch_size"] = 16
    splits = (data[:32], data[32:36], data[36:])
    cfg = tcfg.update_config(copy.deepcopy(cfg), *splits)
    mcfg = tcfg.build_model_config(cfg)
    train_cfg = cfg["NeuralNetwork"]["Training"]
    loader = create_dataloaders(*splits, 16, neighbor_format=dense)[0]
    batch = next(iter(loader)).to(cuda_device)
    runs = []
    for _ in range(2):
        model = create_model(mcfg, device=cuda_device, seed=3)
        tx = topt.select_optimizer(train_cfg)
        state = tstep.TrainState.create(model, tx)
        step = tstep.make_train_step(
            model, mcfg, tx, train_cfg["loss_function_type"],
            compute_grad_energy=bool(train_cfg.get("compute_grad_energy")))
        for _ in range(2):
            state, metrics = step(state, batch)
        runs.append((metrics["loss"].cpu(), {
            k: v.detach().cpu().clone()
            for k, v in state.state_dict().items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of max(|got|, |want|, 2^-10)."""
    g, w = got.float(), want.float()
    scale = torch.maximum(torch.maximum(g.abs(), w.abs()),
                          torch.full_like(g, 2.0 ** -10))
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return float(((g - w).abs() / ulp).max()) if g.numel() else 0.0


def _bf16(*arrays, dev):
    return [_t(a).to(dev).to(torch.bfloat16) if np.asarray(a).dtype
            == np.float32 else _t(a).to(dev) for a in arrays]


def _check_bf16(names, got, want, exact=(), bound=None):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype == torch.bfloat16, name
        if name in exact:
            assert torch.equal(g, w), name
        else:
            err = bf16_ulps(g, w)
            assert err <= (bound or BF16_ULPS).get(name, 1), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [200, 13])
def test_bf16_kernels_match_plain_versions_on_the_card(cuda_device, f):
    """Kernels 2-4 in their bf16 instantiations against the plain bf16
    versions (F = 13: the scalar path), counted apart; random data within
    BF16_ULPS, min/max/count/degree bitwise."""
    dev = cuda_device
    tk.reset_launch_counts()
    nargs = _bf16(*_nbr_inputs(5, n=300, k=16, f=f), dev=dev)
    _check_bf16(("mean", "min", "max", "std", "deg"),
                nbr.nbr_aggregate(*nargs), nbr.nbr_aggregate_plain(*nargs),
                exact=("min", "max", "deg"))
    args = _bf16(*_edge_inputs(5, n=300, e=4000, f=f), dev=dev) + [300]
    _check_bf16(("s", "sq", "cnt", "min", "max"),
                fused_mp.pna_edge_accumulators(*args),
                fused_mp.pna_edge_accumulators_plain(*args),
                exact=("cnt", "min", "max"), bound={"s": 1, "sq": 1})
    h, w, send, recv, emask = _filter_inputs(7, 300, 997, f, dev)
    h, w = h.bfloat16(), w.bfloat16()
    _check_bf16(("out",),
                [fused_mp.filter_scatter(h, w, send, recv, emask, 300)],
                [fused_mp.filter_scatter_plain(h, w, send, recv, emask,
                                               300)])
    counts = tk.launch_counts()
    for name in ("nbr_aggregate", "pna_edge_aggregate", "filter_scatter"):
        assert counts[name] == counts[f"{name}_bf16"] == 1, name
    with pytest.raises(TypeError):       # one dtype for both operands
        nbr.nbr_aggregate(nargs[0], nargs[1].float(), *nargs[2:])
    with pytest.raises(TypeError):       # float32 or bfloat16 only
        fused_mp.filter_scatter(h.half(), w.half(), send, recv, emask, 300)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [200, 13])
def test_bf16_kernels_bitwise_on_tie_rich_dyadic_data(cuda_device, f):
    """On the bf16-exact tie-rich cases (graphs/synthetic.py) every output
    of the bf16 kernels equals the plain version's bit for bit."""
    from hydragnn_tpu_torch.graphs.synthetic import (tie_rich_edge_case,
                                                     tie_rich_neighbor_case)
    dev = cuda_device
    args = _bf16(*tie_rich_neighbor_case(3, n=400, k=24, f=f,
                                         bf16_exact=True), dev=dev)
    for g, w in zip(nbr.nbr_aggregate(*args),
                    nbr.nbr_aggregate_plain(*args)):
        assert torch.equal(g, w)
    args = _bf16(*tie_rich_edge_case(3, n=400, f=f, bf16_exact=True),
                 dev=dev) + [400]
    for g, w in zip(fused_mp.pna_edge_accumulators(*args),
                    fused_mp.pna_edge_accumulators_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [32, 200, 1030])
def test_bf16_filter_scatter_dh_and_long_receivers(cuda_device, f):
    """The bf16 filter-scatter forward and its dh (the kernel on the
    sender-sorted layout) against the plain version forward and on the
    transposed edges, on receivers with 0, 1 and 5000 edges and a sender
    with 4500: h, w, g multiples of 2^-3 in [-2, 2], whose bf16 products
    are exact and whose float32 sums are exact in any order, so both are
    bitwise; dw is the bf16 product g[recv] h[send], bitwise too."""
    dev = cuda_device
    rng = np.random.RandomState(4)
    n, e = 64, 9000
    recv = rng.randint(2, n, e).astype(np.int32)
    recv[:5000] = 40
    recv[5000] = 1
    send = rng.randint(0, n, e).astype(np.int32)
    send[:4500] = 3
    mask = rng.rand(e) > 0.1
    mask[5000] = True
    h, w, g = ((rng.randint(-16, 17, shape) / 8).astype(np.float32)
               for shape in ((n, f), (e, f), (n, f)))
    h, w, g, send, recv, mask = _bf16(h, w, g, send, recv, mask, dev=dev)
    tk.reset_launch_counts()
    th = h.clone().requires_grad_(True)
    tw = w.clone().requires_grad_(True)
    out = fused_mp.filter_scatter(th, tw, send, recv, mask, n)
    dh, dw = torch.autograd.grad((out.float() * g.float()).sum(), (th, tw))
    assert out.dtype == dh.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(out, fused_mp.filter_scatter_plain(h, w, send, recv,
                                                          mask, n))
    # d(sum out * g)/dh, in bf16: g rounded to bf16 is g, exactly
    assert torch.equal(dh, fused_mp.filter_scatter_plain(g, w, recv, send,
                                                         mask, n))
    keep = mask & (recv >= 0) & (recv < n)
    want_dw = torch.where(keep[:, None], g[recv.clamp(0, n - 1).long()]
                          * h[send.long()], torch.zeros_like(w))
    assert torch.equal(dw, want_dw)
    assert not out[0].any() and out[1].any()
    counts = tk.launch_counts()
    assert counts["filter_scatter_bf16"] == counts[
        "filter_scatter_backward_bf16"] == 1


@pytest.mark.cuda
def test_bf16_run_training_resume_is_bitwise(cuda_device, tmp_path,
                                             monkeypatch):
    """A bf16 csce PNA run (hidden 32, 2 layers) with checkpoints every
    epoch, preempted by a real SIGTERM once its first save is committed and
    resumed with `continue`, ends with the history and parameters of the
    uninterrupted run bit for bit; the masters stay float32."""
    import copy
    import json
    import os
    import signal
    import threading
    import time
    from pathlib import Path
    from hydragnn_tpu_torch import run_training
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
    from hydragnn_tpu_torch.train import trainer
    from hydragnn_tpu_torch.utils import checkpoint as ckpt
    root = Path(__file__).resolve().parents[1]
    with open(root / "examples" / "csce" / "csce_gap.json") as fh:
        cfg = json.load(fh)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=32, num_conv_layers=2, dtype="bf16")
    tr = cfg["NeuralNetwork"]["Training"]
    tr.update(num_epoch=4, batch_size=16)
    data = synthetic_molecules(80, seed=2)
    splits = (data[:48], data[48:64], data[64:])
    monkeypatch.chdir(tmp_path)
    state0, h0, _, _ = run_training(copy.deepcopy(cfg), splits)
    tr.update(Checkpoint=True, checkpoint_every_n_epochs=1)
    real_save, sent = ckpt.save_model, []

    def save_then_kill(*args, **kwargs):
        # after the first save, a thread sends SIGTERM; the save returns
        # once the handler has set the flag (the run stops there)
        out = real_save(*args, **kwargs)
        if not sent:
            sent.append(threading.Thread(
                target=os.kill, args=(os.getpid(), signal.SIGTERM)))
            sent[0].start()
            deadline = time.time() + 30
            while not trainer.preemption_requested() \
                    and time.time() < deadline:
                time.sleep(0.001)
        return out
    monkeypatch.setattr(ckpt, "save_model", save_then_kill)
    try:
        _, h1, _, _ = run_training(copy.deepcopy(cfg), splits)
        assert trainer.preemption_requested()
    finally:
        sent[0].join(timeout=60)
        trainer.clear_preemption()
        monkeypatch.setattr(ckpt, "save_model", real_save)
    assert len(h1["train_loss"]) == 1
    tr["continue"] = 1
    state2, h2, _, _ = run_training(copy.deepcopy(cfg), splits)
    for k in ("train_loss", "val_loss", "test_loss", "lr"):
        assert h2[k] == h0[k], k
    for k, v in state0.state_dict().items():
        assert v.dtype == torch.float32
        assert torch.equal(v, state2.state_dict()[k]), k


@pytest.mark.cuda
def test_bf16_ops_round_alike_on_the_card_and_the_cpu(cuda_device):
    """The port's bf16 elementwise ops give the CPU's values bit for bit
    on the card (the softplus's `- log 2`, the Gaussian centres, the
    BatchNorm's eps and rsqrt, the PNA scalers' division: ops/scalars.py),
    and a bf16 Dense, with one output column or many, adds its bias to
    the rounded product on both (cuBLAS would fuse it into the rounding
    for some shapes), whose products agree within one bf16 ulp (they sum
    in different orders), under the device rule of the entry points
    (utils/devices.py: float32 reductions in bf16 matmuls)."""
    from hydragnn_tpu_torch.models.layers import Dense, MaskedBatchNorm
    from hydragnn_tpu_torch.models.schnet import shifted_softplus
    from hydragnn_tpu_torch.ops.basis import gaussian_basis
    from hydragnn_tpu_torch.utils.devices import resolve_device
    resolve_device(cuda_device)   # the entry points' matmul settings
    gen = torch.Generator().manual_seed(9)
    x = (torch.randn(20000, 32, generator=gen) * 2).bfloat16()
    d = (torch.rand(20000, generator=gen) * 2.5).bfloat16()
    bn = MaskedBatchNorm(32).eval()
    with torch.no_grad():
        bn.var.uniform_(1e-3, 2.0, generator=gen)
        bn.mean.normal_(generator=gen)
    mask = torch.ones(20000, dtype=torch.bool)
    ops = {"softplus": lambda t, m: shifted_softplus(t),
           "basis": lambda t, m: gaussian_basis(d.to(t.device), 0.0, 2.0,
                                                32),
           "batchnorm": lambda t, m: m(t, mask.to(t.device))}
    for name, fn in ops.items():
        want = fn(x, bn.bfloat16())
        got = fn(x.to(cuda_device), bn.to(cuda_device)).cpu()
        bn.cpu()
        assert torch.equal(got, want), name
    for out in (1, 32):
        lin = Dense(32, out)
        with torch.no_grad():
            lin.bias.normal_(generator=gen)
        lin = lin.bfloat16()
        products = []
        for dev in ("cpu", cuda_device):
            lin, xd = lin.to(dev), x.to(dev)
            with torch.no_grad():
                product = torch.nn.functional.linear(xd, lin.weight)
                # the bias is added to the rounded product, on each device
                assert torch.equal(lin(xd), product + lin.bias), (out, dev)
            products.append(product.cpu())
        assert bf16_ulps(products[1], products[0]) <= 1.0, out


# ------------------------------------ the PNA backward kernels (B5) --
def _bwd_routes(kind, pi, pj, tables, grads, n):
    """(the backward kernel's, its plain version's) (dproj_i, dproj_j) on
    the same inputs, with the extrema of the forward kernel."""
    if kind == "dense":
        _, mn, mx, _, _ = nbr.nbr_aggregate(pi, pj, *tables)
        return (nbr.nbr_aggregate_bwd(pi, pj, *tables, mn, mx, *grads),
                nbr.nbr_aggregate_vjp(pi, pj, *tables, mn, mx, *grads))
    acc = fused_mp.pna_edge_accumulators(pi, pj, *tables, n)
    return (fused_mp.pna_edge_bwd(pi, pj, *tables, n, acc[3], acc[4],
                                  *grads),
            fused_mp.pna_edge_vjp(pi, pj, *tables, n, acc[3], acc[4],
                                  *grads))


def _assert_bwd_close(got, want, exact):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        if exact:
            assert torch.equal(g, w)
        elif g.dtype == torch.float32:
            torch.testing.assert_close(g, w, **SUM_TOL)
        else:
            assert bf16_ulps(g, w) <= 1.0


def _bwd_random(kind, seed, n, f, dev, dtype, k=16, e=4000):
    """Random inputs with masked slots, indices outside [0, n), a row
    without a slot (n // 2) and a node no slot names (n - 1): (pi, pj,
    tables, cotangents)."""
    rng = np.random.RandomState(seed)
    pi, pj = (_t(rng.randn(n, f).astype(np.float32)).to(dev, dtype)
              for _ in range(2))
    if kind == "dense":
        idx = rng.randint(0, n, (n, k)).astype(np.int32)
        mask = rng.rand(n, k) > 0.3
        mask[n // 2] = False
        idx[idx == n - 1] = 0
        idx[rng.rand(n, k) < 0.03] = n + 3
        idx[rng.rand(n, k) < 0.03] = -1
        tables = [idx, mask]
    else:
        send = rng.randint(0, n, e).astype(np.int32)
        recv = rng.randint(0, n, e).astype(np.int32)
        recv[recv == n // 2] = (n // 2 + 1) % n
        send[send == n - 1] = 0
        recv[:3] = n + 5
        send[3:6] = -2
        tables = [send, recv, rng.rand(e) > 0.2]
    grads = [torch.randn(n, f, device=dev).to(dtype) for _ in range(4)]
    return pi, pj, [_t(a).to(dev) for a in tables], grads


def _dyadic_grads(kind, seed, n, f, dev, dtype):
    """Multiples of 1/8 in [-1/2, 1/2]; no std cotangent (dense) and no
    sq cotangent (edge list), as in the VJP tests."""
    rng = np.random.RandomState(seed)
    grads = [_t(rng.randint(-4, 5, (n, f)) / 8).to(dev, dtype)
             for _ in range(3)]
    grads.insert(3 if kind == "dense" else 1,
                 torch.zeros(n, f, device=dev, dtype=dtype))
    return grads


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "edge"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [200, 33, 6])
def test_pna_backward_kernels_match_torch_vjp(cuda_device, kind, dtype, f):
    """The backward kernels (csrc/pna_backward.cu) against their plain
    versions, the torch-op VJPs, on the card: random data with masked and
    out-of-range slots and a row without a slot within SUM_TOL (float32)
    or one bf16 ulp, and that row's dproj_i and the dproj_j of every node
    no slot names exactly 0; the tie-rich dyadic cases bitwise; two runs
    give the same bits; each call counts its two launches (and two bf16
    launches at bf16)."""
    from hydragnn_tpu_torch.graphs.synthetic import (tie_rich_edge_case,
                                                     tie_rich_neighbor_case)
    dev = cuda_device
    n = 300
    pi, pj, tables, grads = _bwd_random(kind, f, n, f, dev, dtype)
    tk.reset_launch_counts()
    got, want = _bwd_routes(kind, pi, pj, tables, grads, n)
    again, _ = _bwd_routes(kind, pi, pj, tables, grads, n)
    counts = tk.launch_counts()
    name = "nbr_aggregate" if kind == "dense" else "pna_edge_aggregate"
    bf16 = int(dtype == torch.bfloat16)
    assert counts[f"{name}_backward"] == 4
    assert counts[f"{name}_backward_bf16"] == 4 * bf16
    assert counts["segment_sum"] >= 1    # the plain versions' sums
    _assert_bwd_close(got, want, exact=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if kind == "dense":
        idx, mask = (t.cpu().numpy() for t in tables)
        named = idx[mask & (idx >= 0) & (idx < n)]
        assert not got[0][n // 2].any()
    else:
        send, recv, em = (t.cpu().numpy() for t in tables)
        keep = em & (send >= 0) & (send < n) & (recv >= 0) & (recv < n)
        named = send[keep]
        assert not got[0][n // 2].any()
    unnamed = np.setdiff1d(np.arange(n), named)
    assert unnamed.size and not got[1][_t(unnamed).to(dev)].any()
    assert got[0].abs().max() > 0 and got[1].abs().max() > 0

    exact = dtype == torch.bfloat16
    if kind == "dense":
        arrays = tie_rich_neighbor_case(2, n=60, k=8, f=f, bf16_exact=exact)
    else:
        arrays = tie_rich_edge_case(2, n=60, f=f, bf16_exact=exact)
    pi, pj = (_t(a).to(dev, dtype) for a in arrays[:2])
    tables = [_t(a).to(dev) for a in arrays[2:]]
    got, want = _bwd_routes(kind, pi, pj, tables,
                            _dyadic_grads(kind, 5, 60, f, dev, dtype), 60)
    _assert_bwd_close(got, want, exact=True)
    assert got[0].abs().max() > 0 and got[1].abs().max() > 0


def _bwd_special(kind, shape, dev):
    """(n, pi, pj, tables): K = 1 (one in-edge per node), one node, hubs
    (a neighbour named by more than 1,024 slots; on the edge list also a
    receiver with more than 1,024 edges), and long rows (dense: K = 64,
    rows with more kept slots than the kernels stage at once,
    `nbr.STAGE_SLOTS`, one with all 64; edge list: a receiver with 300
    edges). Multiples of 1/64, so that ties occur."""
    rng = np.random.RandomState(11)
    n = {"k1": 50, "one_node": 1, "hub": 1500, "long_row": 120}[shape]
    pi, pj = (_t(rng.randint(-32, 32, (n, 200)) / 64).float().to(dev)
              for _ in range(2))
    if kind == "dense":
        k = {"k1": 1, "one_node": 3, "hub": 4, "long_row": 64}[shape]
        idx = rng.randint(0, n, (n, k)).astype(np.int32)
        mask = rng.rand(n, k) > 0.2
        if shape == "hub":
            idx[:, 0], mask[:, 0] = 7, True
        if shape == "one_node":
            mask[0] = (True, True, False)
        if shape == "long_row":
            mask[9] = True
            assert mask.sum(1).max() > 2 * nbr.STAGE_SLOTS
        tables = [idx, mask]
    else:
        e = {"k1": n, "one_node": 3, "hub": 4000, "long_row": 1000}[shape]
        send = rng.randint(0, n, e).astype(np.int32)
        recv = (np.arange(e) % n).astype(np.int32)
        em = np.ones(e, bool)
        if shape == "hub":
            send[:1200] = 7
            recv[1000:2100] = 3
        if shape == "long_row":
            recv[:300] = 9
        if shape == "one_node":
            em[2] = False
        tables = [send, recv, em]
    return n, pi, pj, [_t(a).to(dev) for a in tables]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "edge"])
@pytest.mark.parametrize("shape", ["k1", "one_node", "hub", "long_row"])
def test_pna_backward_kernels_take_k1_one_node_and_hubs(cuda_device, kind,
                                                        shape):
    """K = 1, a single node, hubs (pass 2 walks one neighbour's 1,500
    slots; on the edge list pass 1 walks one receiver's 1,100 edges
    twice) and long rows (the dense pass 1 stages a row of 64 kept slots
    in chunks), float32 and bf16, against the torch-op VJPs: within
    SUM_TOL (one bf16 ulp)."""
    dev = cuda_device
    n, pi, pj, tables = _bwd_special(kind, shape, dev)
    rng = np.random.RandomState(12)
    grads = [_t(rng.randint(-4, 5, (n, 200)) / 8).float().to(dev)
             for _ in range(4)]
    for dtype in (torch.float32, torch.bfloat16):
        got, want = _bwd_routes(kind, pi.to(dtype), pj.to(dtype), tables,
                                [g.to(dtype) for g in grads], n)
        _assert_bwd_close(got, want, exact=False)
        assert got[1].abs().max() > 0


def _constant_row_reference(h, cnt, eps, branch=None):
    """dproj_i of a row whose `cnt` slots all carry the float32 message
    h, for the cotangents g_std = 1 and g_mean = g_min = g_max = 0, in
    float32 with the sums taken slot after slot (the forward kernel's
    order); `branch` (1, 0.5 or 0) overrides the variance's. Returns
    (dproj_i, the variance's branch)."""
    f32 = np.float32
    s = sq = f32(0)
    for _ in range(cnt):
        s = f32(s + h)
        sq = f32(sq + f32(h * h))
    c = f32(max(cnt, 1))
    m = f32(s / c)
    var = f32(f32(sq / c) - f32(m * m))
    took = 1.0 if var > 0 else (0.5 if var == 0 else 0.0)
    b = took if branch is None else branch
    sd = np.sqrt(f32(max(var, f32(0)) + f32(eps)), dtype=np.float32)
    dv = f32(f32(1) / f32(2 * sd))
    dv = dv if b == 1.0 else (f32(dv * f32(0.5)) if b == 0.5 else f32(0))
    dvm = f32(dv * m)
    ds = f32(f32(f32(f32(0) - dvm) - dvm) / c)
    dsq = f32(dv / c)
    d = f32(ds + f32(2 * f32(h * dsq)))
    acc = f32(0)
    for _ in range(cnt):
        acc = f32(acc + d)
    return acc, took


@pytest.mark.cuda
def test_nbr_backward_variance_branch_on_constant_rows(cuda_device):
    """Rows whose 3-24 slots all name one neighbour carry one non-dyadic
    message, so var = sq / c - mean^2 is 0 or a rounding step either side
    of it, and the summation order picks the branch (1, 1/2 or 0). The
    kernel sums in the forward kernel's slot order: its dproj_i equals a
    float32 reference summed in that order bit for bit, and the torch-op
    VJP, which sums in that order too, takes the kernel's branch on every
    row-feature. The branch torch.sum's order would take is printed."""
    dev = cuda_device
    rng = np.random.RandomState(13)
    n, k, f = 512, 24, 8
    pi = (rng.rand(n, f) * 3 - 1.5).astype(np.float32)
    pj = (rng.rand(n, f) * 3 - 1.5).astype(np.float32)
    cnt = 3 + np.arange(n) % (k - 2)
    idx = np.repeat(rng.randint(0, n, (n, 1)), k, axis=1).astype(np.int32)
    mask = np.arange(k)[None, :] < cnt[:, None]
    args = [_t(a).to(dev) for a in (pi, pj, idx, mask)]
    _, mn, mx, _, _ = nbr.nbr_aggregate(*args)
    zero = torch.zeros(n, f, device=dev)
    grads = (zero, zero, zero, torch.ones(n, f, device=dev))
    got = nbr.nbr_aggregate_bwd(*args, mn, mx, *grads)[0].cpu().numpy()
    branches = np.zeros((n, f))
    for r in range(n):
        for c in range(f):
            h = np.float32(pi[r, c] + pj[idx[r, 0], c])
            want, branches[r, c] = _constant_row_reference(h, int(cnt[r]),
                                                           1e-5)
            assert got[r, c] == want, (r, c, got[r, c], want)
    # the branch of each order: the statistics by the VJP's own ops
    from hydragnn_tpu_torch.ops.segment import (sum_accum_f32,
                                                sum_slots_in_order)
    m = args[3][:, :, None]
    hm = torch.where(m, args[0][:, None] + args[1][args[2].long()],
                     torch.zeros((), device=dev))
    c = torch.clamp(m.sum(1, dtype=torch.float32), min=1.0)

    def branch_counts(b):
        return {v: int((b == v).sum()) for v in (1.0, 0.5, 0.0)}
    took = branch_counts(branches)
    vjp_took = {}
    for name, total in (("torch.sum order", lambda d: sum_accum_f32(d, 1)),
                        ("the torch-op VJP's", sum_slots_in_order)):
        mean = total(hm) / c
        var = (total(hm * hm) / c - mean * mean).cpu().numpy()
        b = np.where(var > 0, 1.0, np.where(var == 0, 0.5, 0.0))
        vjp_took[name] = dict(branch_counts(b),
                              differ=int((b != branches).sum()))
    print(f"constant rows ({n * f} row-features): the kernel's branch "
          f"{took}; by order: {vjp_took}")
    assert vjp_took["the torch-op VJP's"]["differ"] == 0
    assert took[1.0] + took[0.0] > 0     # the rounding reaches both sides


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "edge"])
def test_pna_backward_kernels_replay_in_a_cuda_graph(cuda_device, kind):
    """A backward captured into a CUDA graph (layouts built beforehand,
    as a training forward builds them) replays bit for bit what the eager
    call computes, at float32 and bf16."""
    dev = cuda_device
    n = 300
    for dtype in (torch.float32, torch.bfloat16):
        pi, pj, tables, grads = _bwd_random(kind, 3, n, 200, dev, dtype)
        if kind == "dense":
            _, mn, mx, _, _ = nbr.nbr_aggregate(pi, pj, *tables)
            layouts = (nbr.neighbor_layout(*tables),)

            def call():
                return nbr.nbr_aggregate_bwd(pi, pj, *tables, mn, mx,
                                             *grads, 1e-5, *layouts)
        else:
            acc = fused_mp.pna_edge_accumulators(pi, pj, *tables, n)
            layouts = (fused_mp.edge_layout(*tables, n),
                       fused_mp.edge_layout(tables[1], tables[0], tables[2],
                                            n))
            layouts += (fused_mp.edge_positions(*layouts),)

            def call():
                return fused_mp.pna_edge_bwd(pi, pj, *tables, n, acc[3],
                                             acc[4], *grads, *layouts)
        eager = call()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


# --------------------------- the dense kernels' staged design (B1) --
def _dense_case(case, f, dev, dtype):
    """(pi, pj, nbr, mask) on the card: "random" (K 16, masked and
    out-of-range slots, a row without a slot, a node no slot names),
    "long_rows" (K 64: rows longer than one staging chunk, one with all
    64 slots kept, ties from multiples of 1/64)."""
    rng = np.random.RandomState(f)
    if case == "random":
        pi, pj, tables, _ = _bwd_random("dense", f, 300, f, dev, dtype)
        return (pi, pj, *tables)
    n, k = 120, 64
    pi, pj = (_t(rng.randint(-32, 32, (n, f)) / 64).to(dev, dtype)
              for _ in range(2))
    idx = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.4
    mask[9], mask[10] = True, False
    idx[rng.rand(n, k) < 0.05] = n + 1
    return (pi, pj, _t(idx).to(dev), _t(mask).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [200, 12, 13, 2048])
@pytest.mark.parametrize("case", ["random", "long_rows"])
def test_nbr_forward_long_rows_and_odd_widths_bitwise(cuda_device, dtype, f,
                                                      case):
    """The forward kernel equals its plain version bit for bit on every
    output, at both dtypes: rows of up to 64 kept slots (walked group
    after group in slot order), empty rows, out-of-range ids; loads of 4
    elements (F 200, 12 and 2,048: packed bf16 arithmetic) and of one (F
    13, the fallback width)."""
    args = _dense_case(case, f, cuda_device, dtype)
    assert segment.vec_width(f, args[0], args[1]) == (1 if f == 13 else 4)
    got = nbr.nbr_aggregate(*args)
    want = nbr.nbr_aggregate_plain(*args)
    for name, g, w in zip(("mean", "min", "max", "std", "deg"), got, want):
        assert g.dtype == w.dtype == dtype, name
        assert torch.equal(g, w), name
    assert float(got[4].max()) > nbr.STAGE_SLOTS or case == "random"


def _layout_ordered_sum(dh, layout, n):
    """dproj_j as the float32 sum, in the layout's order, of the rows of
    dh [N K, F] (or [E, F]) that each node's range names, stored in dh's
    dtype: torch ops (rows padded to the longest range, then
    `sum_slots_in_order`). `layout` starts with (row_ptr, order): the
    neighbour layout, or an edge layout's (row_ptr, edge order)."""
    from hydragnn_tpu_torch.ops.segment import sum_slots_in_order
    row_ptr, order = (t.long() for t in layout[:2])
    kept = int(row_ptr[-1])
    counts = row_ptr[1:] - row_ptr[:-1]
    col = torch.repeat_interleave(torch.arange(n, device=dh.device), counts)
    rank = torch.arange(kept, device=dh.device) - row_ptr[col]
    buf = torch.zeros((n, max(int(counts.max()), 1), dh.shape[1]),
                      device=dh.device)
    buf[col, rank] = dh[order[:kept]].float()
    return sum_slots_in_order(buf).to(dh.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [200, 12, 13, 2048])
@pytest.mark.parametrize("case", ["random", "long_rows"])
def test_nbr_backward_sums_the_vjp_slot_gradients_bitwise(cuda_device,
                                                          dtype, f, case):
    """The dense backward kernel writes each kept slot's dh to its place
    in the column-sorted layout and sums those rows in order: its dproj_j
    equals, bit for bit, the torch-op VJP's own slot gradients
    (`nbr.slot_grads`) summed in float32 in the layout's order
    (`_layout_ordered_sum`), and its dproj_i their sum in slot order; both
    also within SUM_TOL (one bf16 ulp) of the torch-op VJP, whose
    dproj_j sums in the segment-sum kernel's order. Long rows (pass 1
    stages them chunk after chunk), empty rows, out-of-range ids and both
    load widths, as the forward test; at F 2,048 the staging asks for
    more than 48 KB of shared memory."""
    from hydragnn_tpu_torch.ops.segment import sum_slots_in_order
    dev = cuda_device
    pi, pj, idx, mask = _dense_case(case, f, dev, dtype)
    n = pi.shape[0]
    if f == 2048:
        assert nbr.row_geometry(idx.shape[1], f, 4, pi.element_size(),
                                stage=True)[3] > 48 * 1024
    rng = np.random.RandomState(3)
    grads = [_t(rng.randn(n, f).astype(np.float32)).to(dev, dtype)
             for _ in range(4)]
    _, mn, mx, _, _ = nbr.nbr_aggregate(pi, pj, idx, mask)
    layout = nbr.neighbor_layout(idx, mask)
    got = nbr.nbr_aggregate_bwd(pi, pj, idx, mask, mn, mx, *grads, 1e-5,
                                layout)
    dh, _ = nbr.slot_grads(pi, pj, idx, mask, mn, mx, *grads)
    assert torch.equal(got[0], sum_slots_in_order(dh))
    assert torch.equal(got[1], _layout_ordered_sum(
        dh.reshape(n * idx.shape[1], f), layout, n))
    _assert_bwd_close(got, nbr.nbr_aggregate_vjp(pi, pj, idx, mask, mn, mx,
                                                 *grads, 1e-5, layout),
                      exact=False)
    assert got[0].abs().max() > 0 and got[1].abs().max() > 0


# ------------------------- the edge-list kernels' staged design (B2) --
def _edge_case(case, f, dev, dtype):
    """(pi, pj, senders, receivers, edge_mask, n) on the card: "random"
    (`_bwd_random`'s edges: masked edges, ids outside [0, N), a receiver
    without an edge, a node no edge names), "loader" (the csce training
    loader's shape as an edge list: N 8,192, E 131,072, about 50,000 kept
    edges on its first 4,304 nodes, the rest padding), "long" (a receiver
    and a sender with more edges than the backward stages at once,
    `nbr.STAGE_SLOTS`; multiples of 1/64, so that ties occur) and
    "all_masked" (no kept edge)."""
    rng = np.random.RandomState(f)
    if case == "random":
        pi, pj, tables, _ = _bwd_random("edge", f, 300, f, dev, dtype)
        return (pi, pj, *tables, 300)
    n, e = {"loader": (8192, 131072), "long": (120, 2000),
            "all_masked": (90, 700)}[case]
    if case == "long":
        pi, pj = (_t(rng.randint(-32, 32, (n, f)) / 64).to(dev, dtype)
                  for _ in range(2))
    else:
        pi, pj = (_t(rng.randn(n, f).astype(np.float32)).to(dev, dtype)
                  for _ in range(2))
    real = 4304 if case == "loader" else n
    send = rng.randint(0, real, e).astype(np.int32)
    recv = rng.randint(0, real, e).astype(np.int32)
    em = rng.rand(e) > 0.2
    if case == "loader":
        em[50749:] = False
        send[50749:] = recv[50749:] = 0
    elif case == "long":
        recv[:300] = 9
        send[500:900] = 11
        recv[1000:1030] = n + 4
    else:
        em[:] = False
    return (pi, pj, *(_t(a).to(dev) for a in (send, recv, em)), n)


_EDGE_SHAPES = [("random", 200), ("random", 12), ("random", 13),
                ("random", 2048), ("long", 200), ("long", 13),
                ("loader", 200), ("all_masked", 200), ("all_masked", 13)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,f", _EDGE_SHAPES)
def test_edge_backward_sums_the_vjp_edge_gradients_bitwise(cuda_device,
                                                           dtype, case, f):
    """The edge-list backward kernel writes each kept edge's dh to its
    position in the sender-sorted layout and sums those rows in order:
    its dproj_i equals, bit for bit, the torch-op VJP's own edge
    gradients (`fused_mp.edge_grads`) summed in float32 in the
    receiver-sorted layout's order, and its dproj_j the same gradients
    summed in the sender-sorted layout's order (`_layout_ordered_sum`);
    both also within SUM_TOL (one bf16 ulp) of the torch-op VJP. Two
    launches a call. The loader shape, F 12 / 13 (loads of 4 elements and
    of one), F 2,048 (pass 1 asks for more than 48 KB of shared memory),
    a receiver and a sender longer than a chunk, a receiver without an
    edge, every edge masked."""
    dev = cuda_device
    pi, pj, send, recv, em, n = _edge_case(case, f, dev, dtype)
    tables = (send, recv, em, n)
    if f == 2048:
        assert fused_mp.edge_geometry(f, 4, pi.element_size())[3] \
            > 48 * 1024
    rng = np.random.RandomState(3)
    grads = [_t(rng.randn(n, f).astype(np.float32)).to(dev, dtype)
             for _ in range(4)]
    acc = fused_mp.pna_edge_accumulators(pi, pj, *tables)
    layout = fused_mp.edge_layout(*tables)
    layout_t = fused_mp.edge_layout(recv, send, em, n)
    pos = fused_mp.edge_positions(layout, layout_t)
    tk.reset_launch_counts()
    got = fused_mp.pna_edge_bwd(pi, pj, *tables, acc[3], acc[4], *grads,
                                layout, layout_t, pos)
    counts = tk.launch_counts()
    assert counts["pna_edge_aggregate_backward"] == 2
    assert counts["pna_edge_aggregate_backward_bf16"] == \
        2 * int(dtype == torch.bfloat16)
    by_recv, _ = fused_mp.segment_layouts((layout, layout_t))
    dh, _, _ = fused_mp.edge_grads(pi, pj, *tables, acc[3], acc[4], *grads,
                                   by_recv)
    assert torch.equal(got[0], _layout_ordered_sum(
        dh, (layout[0], layout[2]), n))
    assert torch.equal(got[1], _layout_ordered_sum(
        dh, (layout_t[0], layout_t[2]), n))
    _assert_bwd_close(got, fused_mp.pna_edge_vjp(
        pi, pj, *tables, acc[3], acc[4], *grads, layout, layout_t),
        exact=False)
    if case == "all_masked":
        assert not got[0].any() and not got[1].any()
    else:
        assert got[0].abs().max() > 0 and got[1].abs().max() > 0
    if case == "random":
        assert not got[0][n // 2].any()


def _edge_accumulators_in_order(pi, pj, send, recv, em, n):
    """(s, sq, cnt, mn, mx) of the plain version, with s and sq summed in
    float32 in the receiver-sorted layout's order (each receiver's edges
    in edge order, the kernel's order) and stored in the projections'
    dtype; the messages h and h * h rounded to it as the plain version
    rounds them."""
    keep = fused_mp._kept_edges(send, recv, em, n)
    zero = torch.zeros_like(send)
    h = (pi[torch.where(keep, recv, zero).long()]
         + pj[torch.where(keep, send, zero).long()])
    layout = fused_mp.edge_layout(send, recv, em, n)
    order = (layout[0], layout[2])
    plain = fused_mp.pna_edge_accumulators_plain(pi, pj, send, recv, em, n)
    return (_layout_ordered_sum(h, order, n),
            _layout_ordered_sum(h * h, order, n)) + plain[2:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case,f", [("random", 200), ("random", 13),
                                    ("long", 200), ("loader", 200)])
@pytest.mark.parametrize("rows", [0, 4])
def test_edge_forward_bitwise_in_edge_order(cuda_device, monkeypatch, dtype,
                                            case, f, rows):
    """The edge-list forward kernel equals its plain version bit for bit
    on every output, at both dtypes and both launch geometries (flat,
    whole-warp rows), once the plain sums run in the kernel's order: at
    bf16 the packed pairs (VEC 4) and the float path (F 13) round h and
    h * h as the bf16 ops do (0 ulps), and min and max are exact."""
    dev = cuda_device
    monkeypatch.setitem(fused_mp.FORWARD_ROWS, dtype, rows)
    pi, pj, send, recv, em, n = _edge_case(case, f, dev, dtype)
    got = fused_mp.pna_edge_accumulators(pi, pj, send, recv, em, n)
    want = _edge_accumulators_in_order(pi, pj, send, recv, em, n)
    for name, g, w in zip(("s", "sq", "cnt", "min", "max"), got, want):
        assert g.dtype == w.dtype == dtype, name
        assert torch.equal(g, w), name


# ------------------------------------------------------ CUDA graphs --
# Captured train and eval steps (train/step_graphs.py) and the serving
# engine's per-bucket graphs against the eager bodies they were captured
# from, on the same card: every comparison is bitwise (the same kernels
# on the same inputs, no atomic float scatter on these paths).

ROOT = Path(__file__).resolve().parents[1]


def _step_setup(dev, kind, dtype="float32", accumulate=1, lr=None):
    """(model config, train config, 7 loader batches on the card) of csce
    PNA (dense or edge list), LJ SchNet EF, the OC20 energy EGNN or
    qm9.json's GIN (dense or edge list) at the published widths, 4 graphs
    a batch."""
    import copy
    import json
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                     oc20_slabs,
                                                     qm9_molecules,
                                                     synthetic_molecules)
    from hydragnn_tpu_torch.models.create import data_input_dim
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    if kind == "schnet":
        path, data = "examples/LennardJones/LJ.json", lj_configurations(
            36, seed=1)
    elif kind.startswith("egnn"):
        path, data = ("examples/open_catalyst_2020/open_catalyst_energy.json",
                      oc20_slabs(36, seed=1))
    elif kind.startswith("gin"):
        path, data = "examples/qm9/qm9.json", qm9_molecules(36, seed=1)
    else:
        path, data = "examples/csce/csce_gap.json", synthetic_molecules(
            36, seed=1)
    with open(ROOT / path) as fh:
        cfg = json.load(fh)
    cfg["NeuralNetwork"].pop("Profile", None)
    dense = kind in ("pna_dense", "egnn_dense", "gin_dense")
    arch, tr = cfg["NeuralNetwork"]["Architecture"], \
        cfg["NeuralNetwork"]["Training"]
    arch["neighbor_format"] = dense
    arch["dtype"] = dtype
    tr["batch_size"] = 4
    tr["gradient_accumulation_steps"] = accumulate
    if lr is not None:
        tr["Optimizer"]["learning_rate"] = lr
    splits = (data[:28], data[28:32], data[32:])
    cfg = tcfg.update_config(copy.deepcopy(cfg), *splits)
    loader = create_dataloaders(*splits, 4, neighbor_format=dense)[0]
    batches = [b.to(dev) for b in loader]
    assert len(batches) == 7
    return data_input_dim(tcfg.build_model_config(cfg), data), \
        cfg["NeuralNetwork"]["Training"], batches


def _fresh_state(dev, mcfg, train_cfg):
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import optimizer as topt
    from hydragnn_tpu_torch.train import train_step as tstep
    model = create_model(mcfg, device=dev, seed=3)
    tx = topt.select_optimizer(train_cfg)
    return model, tx, tstep.TrainState.create(model, tx)


def _step_kwargs(train_cfg):
    return dict(loss_name=train_cfg["loss_function_type"],
                compute_grad_energy=bool(train_cfg.get("compute_grad_energy")))


def _host_state(state):
    """Every tensor of a state on the host, and its counters."""
    opt = state.opt_state
    tensors = {**{f"p/{k}": v.detach().cpu().clone()
                  for k, v in state.state_dict().items()},
               **{f"s/{k}/{i}": t.cpu().clone()
                  for k, ts in opt.slots.items() for i, t in enumerate(ts)},
               **{f"a/{i}": t.cpu().clone()
                  for i, t in enumerate(opt.acc_grads or ())}}
    return tensors, (state.step, opt.count, opt.mini_step,
                     opt.gradient_step, opt.learning_rate)


def _assert_same_state(a, b):
    (ta, ca), (tb, cb) = a, b
    assert ca == cb
    for k, v in ta.items():
        assert torch.equal(v, tb[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["pna_dense", "pna_edge", "schnet",
                                  "egnn_dense", "egnn_edge", "gin_dense",
                                  "gin_edge"])
def test_captured_steps_equal_eager_steps_bitwise(cuda_device, kind, dtype):
    """Six eager steps against a captured group of S = 4, a learning-rate
    change between replays, then two captured single steps (the S = 1
    graph, as the remainder of a group runs): each step's metrics, and
    every parameter, running statistic and optimizer slot afterwards,
    bitwise. The launch counters count a replay's kernels as the eager
    steps count theirs."""
    from hydragnn_tpu_torch.train import optimizer as topt
    from hydragnn_tpu_torch.train import train_step as tstep
    dev = cuda_device
    mcfg, train_cfg, batches = _step_setup(dev, kind, dtype)
    kw = _step_kwargs(train_cfg)
    runs = []
    for graphed in (False, True):
        model, tx, state = _fresh_state(dev, mcfg, train_cfg)
        single = tstep.make_train_step(model, mcfg, tx, **kw)
        multi = tstep.make_multi_train_step(model, mcfg, tx, **kw)
        losses = []
        if graphed:
            state, m = multi(state, batches[:4])
            losses += m["loss"].cpu().tolist()
        else:
            for b in batches[:4]:
                state, m = single.eager(state, b)
                losses.append(float(m["loss"]))
        topt.set_learning_rate(state.opt_state, 0.5 * topt.get_learning_rate(
            state.opt_state))
        for i, b in enumerate(batches[4:6]):
            if i == 1:      # past the S = 1 capture and its warm-up runs
                tk.reset_launch_counts()
            state, m = (single if graphed else single.eager)(state, b)
            losses.append(float(m["loss"]))
            assert float(m["nonfinite_steps"]) == 0.0
        torch.cuda.synchronize()
        runs.append((losses, _host_state(state), tk.launch_counts()))
    (la, sa, ca), (lb, sb, cb) = runs
    assert la == lb
    _assert_same_state(sa, sb)
    assert ca == cb and sum(ca.values()) > 0


@pytest.mark.cuda
def test_captured_steps_replay_a_restored_and_a_resumed_state(
        cuda_device, tmp_path, monkeypatch):
    """A captured step keeps reading the state's tensors: after
    `TrainState.restore` (keep_best's route) and after a checkpoint
    resume (load_existing_model + restore, `continue`'s route) its
    replays repeat the steps taken from that point bitwise; a state
    whose tensors are not the captured ones raises."""
    from hydragnn_tpu_torch.train import train_step as tstep
    from hydragnn_tpu_torch.utils import checkpoint as ckpt
    monkeypatch.chdir(tmp_path)
    dev = cuda_device
    mcfg, train_cfg, batches = _step_setup(dev, "pna_edge")
    model, tx, state = _fresh_state(dev, mcfg, train_cfg)
    multi = tstep.make_multi_train_step(model, mcfg, tx,
                                        **_step_kwargs(train_cfg))
    state, _ = multi(state, batches[:2])
    snap = state.copy()
    ckpt.save_model(state, "graphs")
    state, m1 = multi(state, batches[2:4])
    after = _host_state(state)
    state.restore(snap)
    state, m2 = multi(state, batches[2:4])
    assert torch.equal(m1["loss"], m2["loss"])
    _assert_same_state(after, _host_state(state))
    state.restore(ckpt.load_existing_model(state, "graphs"))
    state, m3 = multi(state, batches[2:4])
    assert torch.equal(m1["loss"], m3["loss"])
    _assert_same_state(after, _host_state(state))
    fresh = tstep.TrainState.create(model, tx)   # new optimizer slots
    with pytest.raises(RuntimeError, match="restore a state in place"):
        multi(fresh, batches[2:4])


@pytest.mark.cuda
def test_captured_accumulation_phases_equal_eager_steps_bitwise(
        cuda_device):
    """gradient_accumulation_steps 3 with groups of S = 2: the groups
    start at phases 0, 2 and 1 (three graphs), and six captured steps
    equal six eager ones bitwise, with the multi eval step's metrics
    equal to the eager eval steps'."""
    from hydragnn_tpu_torch.train import train_step as tstep
    dev = cuda_device
    mcfg, train_cfg, batches = _step_setup(dev, "pna_edge", accumulate=3)
    kw = _step_kwargs(train_cfg)
    runs = []
    for graphed in (False, True):
        model, tx, state = _fresh_state(dev, mcfg, train_cfg)
        multi = tstep.make_multi_train_step(model, mcfg, tx, **kw)
        losses = []
        for g in range(3):
            group = batches[2 * g:2 * g + 2]
            state, m = (multi if graphed else multi.eager)(state, group)
            losses += m["loss"].cpu().tolist()
        if graphed:
            assert len(multi.steps.graphs) == 3
        ev = tstep.make_multi_eval_step(model, mcfg, **kw)
        evals = (ev(state, batches[:2]) if graphed else
                 ev.steps.eager(state, batches[:2])[0])
        runs.append((losses, _host_state(state),
                     evals["loss"].cpu().tolist()))
    (la, sa, ea), (lb, sb, eb) = runs
    assert la == lb and ea == eb
    _assert_same_state(sa, sb)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pna", "ef"])
def test_engine_bucket_graphs_equal_the_eager_forward(cuda_device, kind):
    """Each bucket's captured forward (EF: forward and forces) against
    the eager forward on the same padded batch, bitwise; batched = single
    on the bucket a request was served on; every bucket captured at
    warm-up, with its capture time; a replay counts its kernels."""
    import json
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                     synthetic_molecules)
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    dev = cuda_device
    if kind == "ef":
        path, data = "examples/LennardJones/LJ.json", lj_configurations(
            24, seed=2)
    else:
        path, data = "examples/csce/csce_gap.json", synthetic_molecules(
            24, seed=2)
    with open(path) as fh:
        cfg = json.load(fh)
    cfg = tcfg.update_config(cfg, data[:16], data[16:20], data[20:])
    mcfg = tcfg.build_model_config(cfg)
    model = create_model(mcfg, device=dev, seed=4)
    with InferenceEngine(model, mcfg, reference_samples=data,
                         max_batch_size=8, max_wait_ms=20.0,
                         ef_forward=kind == "ef", device=dev) as engine:
        assert engine.warmup() == len(engine.buckets)
        assert set(engine.capture_ms) == set(engine.buckets)
        futs = [engine.submit(s) for s in data]
        results = [f.result(timeout=120) for f in futs]
        for s, fut, res in zip(data, futs, results):
            single = engine.forward_single(s, bucket=fut.bucket)
            for a, b in zip(res, single):
                np.testing.assert_array_equal(a, b)
        for bucket in engine.buckets:
            batch = engine._collate_bucket(data[:1], bucket)
            cap = engine._graphs[bucket]
            tk.reset_launch_counts()
            got, _ = engine._forward([engine_request(data[0])], bucket)
            assert tk.launch_counts() == cap.launches
            assert sum(cap.launches.values()) > 0
            want = [o.detach().cpu().numpy()
                    for o in engine._run(batch.to(dev))]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def engine_request(sample):
    from concurrent.futures import Future
    from hydragnn_tpu_torch.serving.engine import _Request
    return _Request(sample, Future())


# ------------------------------------------- packing and edge features --
# Batch packing and PNA edge features on the card: the segment sum at the
# shapes these paths give it (the eam edge list's [E, 2F + 1] statistics,
# F = 101 on the scalar-load path, and the pooling over a packed batch's
# graph slots), PNA with edge lengths card vs CPU, and captured packed
# steps against their eager bodies.

def _eam_samples(tmp_path, num=24):
    import json
    from hydragnn_tpu_torch.datasets.cfgdataset import CFGDataset
    from hydragnn_tpu_torch.graphs.synthetic import ninb_cfg_files
    with open(ROOT / "examples/eam/NiNb_EAM_energy.json") as fh:
        cfg = json.load(fh)
    cfg["Visualization"]["create_plots"] = False
    ninb_cfg_files(str(tmp_path), num)
    return cfg, list(CFGDataset(cfg, str(tmp_path)))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["eam_stats", "packed_pooling"])
def test_segment_sum_at_the_packing_and_edge_feature_shapes(cuda_device,
                                                            shape):
    """[E, 101] float32 rows by unsorted receivers (the eam edge list's
    packed sum / sum of squares / count, vec 1), and [N 4,224, 200] rows
    by sorted graph ids into 424 slots (the packed csce pooling), against
    the plain version within SUM_TOL; a bf16 input raises (the kernel
    takes float32)."""
    rng = np.random.RandomState(3)
    if shape == "eam_stats":
        e, n, f = 6144, 513, 101
        ids = np.sort(rng.randint(0, n - 1, e)).astype(np.int32)
        ids[-100:] = n - 1              # padding edges on the padding node
        ids = ids[rng.permutation(e)]
        sorted_ids = False
    else:
        e, n, f = 4224, 424, 200
        ids = np.sort(rng.randint(0, n, e)).astype(np.int32)
        sorted_ids = True
    data = _t(rng.randn(e, f).astype(np.float32)).to(cuda_device)
    ids = _t(ids).to(cuda_device)
    before = tk.launch_counts()["segment_sum"]
    got = segment.segment_sum(data, ids, n, indices_are_sorted=sorted_ids)
    assert tk.launch_counts()["segment_sum"] == before + 1
    want = segment.segment_sum_plain(data, ids, n)
    torch.testing.assert_close(got, want, **SUM_TOL)
    with pytest.raises(TypeError):
        segment.segment_sum(data.bfloat16(), ids, n)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["receivers", "senders", "nbr",
                                   "nbr_edge"])
def test_gather_rows_backward_over_the_edge_feature_layouts(cuda_device,
                                                            tmp_path, which):
    """The eam PNA gathers' gradients at a loader batch of NiNb cells
    (F = 50): on the edge list by receivers and by senders, on the dense
    layout the [N K] table's slots by neighbour into N and by edge id into
    E, each one launch of the segment-sum kernel over the layout
    PNAStack.conv_args builds, against the CPU's plain gradient within
    SUM_TOL; masked rows carry gradient 0, as on the model's path."""
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    _, samples = _eam_samples(tmp_path)
    dense = which.startswith("nbr")
    b = next(iter(create_dataloaders(samples, [], [], 16,
                                     neighbor_format=dense)[0]))
    if dense:
        ids, keep = getattr(b, which).reshape(-1), b.nbr_mask.reshape(-1)
        n = b.num_nodes if which == "nbr" else b.num_edges
    else:
        ids, keep, n = getattr(b, which), b.edge_mask, b.num_nodes
    rng = np.random.RandomState(5)
    x = _t(rng.randn(n, 50).astype(np.float32))
    g = _t(rng.randn(ids.shape[0], 50).astype(np.float32)) * keep[:, None]
    grads = []
    for dev in ("cpu", cuda_device):
        xd = x.detach().to(dev).requires_grad_()
        i, k = ids.to(dev), keep.to(dev)
        layout = segment.segment_layout(i, n, k) if dev != "cpu" else None
        before = tk.launch_counts()["segment_sum"]
        segment.gather_rows(xd, i, layout).backward(g.to(dev))
        grads.append((xd.grad.cpu(),
                      tk.launch_counts()["segment_sum"] - before))
    (want, _), (got, launched) = grads
    assert launched == 1
    torch.testing.assert_close(got, want, **SUM_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False])
def test_pna_edge_features_card_matches_cpu(cuda_device, tmp_path, dense):
    """The eam PNA (edge lengths, hidden 50, 3 layers) in training mode on
    a batch of NiNb cells: the loss within rtol 1e-4 / atol 1e-5 of the
    CPU's, and each weight gradient within 1e-2 relative L2 of the CPU's,
    or ten times the CPU float32 gradient's own gap to float64 where that
    is larger (chip_smoke's gradient bound: float32 gradients of this
    model's first layers are a few percent off float64 on any device, and
    the biases ahead of a batch norm are 0 but for rounding; a lost
    gradient path gives 1). On the edge list the unfused statistics go
    through the segment-sum kernel."""
    import copy
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train import train_step as tstep
    cfg, samples = _eam_samples(tmp_path)
    cfg["NeuralNetwork"]["Architecture"]["num_conv_layers"] = 3
    cfg = tcfg.update_config(copy.deepcopy(cfg), samples)
    mcfg = tcfg.build_model_config(cfg)
    batch = next(iter(create_dataloaders(samples, [], [], 16,
                                         neighbor_format=dense)[0]))
    runs = []
    for dev, dtype in ((cuda_device, torch.float32),
                       (torch.device("cpu"), torch.float32),
                       (torch.device("cpu"), torch.float64)):
        model = create_model(mcfg, device=dev, seed=2).to(dtype)
        model.train()
        b = batch.replace(**{k: getattr(batch, k).to(dtype) for k in (
            "x", "pos", "y_node", "edge_attr", "edge_shifts")}).to(dev)
        before = tk.launch_counts()["segment_sum"]
        total, _ = tstep.make_loss_fn(model, mcfg, "mse")(b)
        grads = torch.autograd.grad(total, list(model.parameters()))
        launched = tk.launch_counts()["segment_sum"] - before
        runs.append((float(total), [g.cpu().double() for g in grads],
                     launched))
    (l_card, g_card, n_card), (l_cpu, g_cpu, _), (_, g64, _) = runs
    assert np.isclose(l_card, l_cpu, rtol=1e-4, atol=1e-5)

    def rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)
    for a, b, w in zip(g_card, g_cpu, g64):
        assert rel(a, b) <= max(1e-2, 10 * rel(b, w))
    # pooling, and on the edge list each layer's statistics and the
    # gathers' gradients
    assert n_card >= (1 if dense else 1 + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False])
def test_captured_packed_steps_equal_eager_steps_bitwise(cuda_device, dense):
    """csce PNA on packed batches (one budget, a variable number of graphs
    a bin): five eager steps against five captured single steps, bitwise
    (metrics, parameters, statistics, slots), and every packed batch
    replays the one graph."""
    import copy
    import json
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train import train_step as tstep
    data = synthetic_molecules(120, seed=2)
    with open(ROOT / "examples/csce/csce_gap.json") as fh:
        cfg = json.load(fh)
    cfg["NeuralNetwork"]["Architecture"]["neighbor_format"] = dense
    splits = (data[:90], data[90:105], data[105:])
    cfg = tcfg.update_config(copy.deepcopy(cfg), *splits)
    mcfg = tcfg.build_model_config(cfg)
    train_cfg = cfg["NeuralNetwork"]["Training"]
    loader = create_dataloaders(*splits, 16, neighbor_format=dense,
                                packing=True)[0]
    batches = [b.to(cuda_device) for b in loader][:5]
    counts = {int(b.graph_mask.sum()) for b in batches}
    assert len(batches) == 5 and len(counts) > 1
    runs = []
    for graphed in (False, True):
        model, tx, state = _fresh_state(cuda_device, mcfg, train_cfg)
        step = tstep.make_train_step(model, mcfg, tx,
                                     **_step_kwargs(train_cfg))
        losses = []
        for b in batches:
            state, m = (step if graphed else step.eager)(state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs.append((losses, _host_state(state), len(step.steps.graphs)))
    (la, sa, _), (lb, sb, graphs) = runs
    assert la == lb
    _assert_same_state(sa, sb)
    assert graphs == 1


# the models of the invariant family and EGNN at a small size: (model
# type, architecture keys over the csce config; None: the OC20 EGNN)
NEW_MODELS = {
    "GIN": {}, "SAGE": {}, "GAT": {}, "MFC": {},
    "CGCNN": {"edge_features": ["length"]},
    "PNAPlus": {"radius": 1.8, "num_radial": 6, "envelope_exponent": 5},
    "EGNN": None}


def _new_model_setup(model_type, dense):
    """(model config, one loader batch on the host) of `model_type` at
    hidden 16 and 2 layers over 16 graphs: synthetic molecules (edge
    lengths as edge features for CGCNN) or, for EGNN, periodic OC20 slabs
    under the OC20 energy config."""
    import copy
    import json
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import (oc20_slabs,
                                                     synthetic_molecules)
    from hydragnn_tpu_torch.models.create import data_input_dim
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    arch_over = NEW_MODELS[model_type]
    if arch_over is None:
        path = "examples/open_catalyst_2020/open_catalyst_energy.json"
        data = oc20_slabs(16, seed=2)
    else:
        path = "examples/csce/csce_gap.json"
        data = synthetic_molecules(16, seed=2, min_atoms=4, max_atoms=30)
        if "edge_features" in arch_over:
            for s in data:
                vec = s.pos[s.senders] - s.pos[s.receivers]
                s.edge_attr = np.linalg.norm(vec, axis=1,
                                             keepdims=True).astype(np.float32)
    with open(ROOT / path) as fh:
        cfg = json.load(fh)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(model_type=model_type, hidden_dim=16, num_conv_layers=2,
                neighbor_format=dense, **(arch_over or {}))
    for head in arch["output_heads"].values():
        head["dim_headlayers"] = [16, 16]
    cfg = tcfg.update_config(copy.deepcopy(cfg), data)
    batch = next(iter(create_dataloaders(data, [], [], 8,
                                         neighbor_format=dense)[0]))
    return data_input_dim(tcfg.build_model_config(cfg), data), batch


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "edge"])
@pytest.mark.parametrize("model_type", sorted(NEW_MODELS))
def test_new_models_card_matches_cpu(cuda_device, model_type, dense):
    """Each model of this family on the card against the same weights on
    the CPU: the eval-mode forward within rtol 1e-4 / atol 1e-5, then one
    training-mode loss within the same bound and each weight gradient
    within 1e-2 relative L2 of the CPU's (or ten times the CPU float32
    gradient's own gap to float64, chip_smoke's gradient bound), with the
    segment-sum kernel launched on the card; and one SGD train step,
    finite on both devices."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import optimizer as topt
    from hydragnn_tpu_torch.train import train_step as tstep
    mcfg, batch = _new_model_setup(model_type, dense)
    runs = []
    for dev, dtype in ((cuda_device, torch.float32),
                       (torch.device("cpu"), torch.float32),
                       (torch.device("cpu"), torch.float64)):
        model = create_model(mcfg, device=dev, seed=2).to(dtype)
        b = batch.replace(**{k: getattr(batch, k).to(dtype) for k in (
            "x", "pos", "y_graph", "edge_attr", "edge_shifts")
            if getattr(batch, k) is not None}).to(dev)
        with torch.no_grad():
            out, _ = model(b)
        model.train()
        before = tk.launch_counts()["segment_sum"]
        total, _ = tstep.make_loss_fn(model, mcfg, "mse")(b)
        grads = torch.autograd.grad(total, list(model.parameters()),
                                    allow_unused=True, materialize_grads=True)
        launched = tk.launch_counts()["segment_sum"] - before
        runs.append((out[0].detach().cpu().double(), float(total.detach()),
                     [g.cpu().double() for g in grads], launched))
    (o_card, l_card, g_card, n_card), (o_cpu, l_cpu, g_cpu, _), \
        (_, _, g64, _) = runs
    gm = batch.graph_mask
    assert torch.isfinite(o_card[gm]).all()
    np.testing.assert_allclose(o_card[gm].numpy(), o_cpu[gm].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert np.isclose(l_card, l_cpu, rtol=1e-4, atol=1e-5)

    def rel(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)
    for a, b, w in zip(g_card, g_cpu, g64):
        assert rel(a, b) <= max(1e-2, 10 * rel(b, w))
    assert n_card >= 1
    for dev in (cuda_device, torch.device("cpu")):
        model = create_model(mcfg, device=dev, seed=2)
        tx = topt.select_optimizer({"Optimizer": {"type": "SGD",
                                                  "learning_rate": 1e-3}})
        state = tstep.TrainState.create(model, tx)
        state, m = tstep.make_train_step(model, mcfg, tx, "mse").eager(
            state, batch.to(dev))
        assert np.isfinite(float(m["loss"]))
        assert float(m["nonfinite_steps"]) == 0.0


# ------------------------------------- serving: faults, swap, structures --
# The engine's failure semantics, hot swap and raw-structure serving with
# its buckets captured as CUDA graphs: a swap copies into the tensors the
# graphs read (nothing is recaptured), a batch that fails after its
# static batch was filled leaves the next batch on the same bucket
# bitwise `forward_single`, and an MD session serves every step from the
# one bucket captured at warm-up.

def _lj_engine_parts(dev, seed):
    import json
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import lj_configurations
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)
    data = lj_configurations(24, seed=2)
    with open(ROOT / "examples/LennardJones/LJ.json") as fh:
        cfg = json.load(fh)
    cfg = tcfg.update_config(cfg, data[:16], data[16:20], data[20:])
    mcfg = tcfg.build_model_config(cfg)

    def model_for(variables):
        model = create_model(mcfg, device=dev)
        model.load_state_dict(load_jax_variables(variables))
        return model

    cpu_model = create_model(mcfg, device="cpu")
    return (data, mcfg, model_for, random_flax_variables(cpu_model, seed),
            random_flax_variables(cpu_model, seed + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_swap_under_captured_graphs(cuda_device, dtype):
    """swap_variables mid-stream: the results after it equal a fresh
    engine's on the new weights, bucket for bucket, bitwise (at bf16 the
    frozen bf16 copies are re-cast in place); each future carries its
    version; no bucket is recaptured; a mismatched tree raises first."""
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    data, mcfg, model_for, v0, v1 = _lj_engine_parts(cuda_device, 5)
    kw = dict(reference_samples=data, max_batch_size=8, max_wait_ms=20.0,
              ef_forward=True, compute_dtype=dtype, device=cuda_device)
    with InferenceEngine(model_for(v0), mcfg, model_version="a", **kw) as eng, \
            InferenceEngine(model_for(v1), mcfg, **kw) as fresh:
        eng.warmup()
        captured = dict(eng.capture_ms)
        before = [eng.submit(s) for s in data]
        [f.result(timeout=120) for f in before]
        bad = {"params": {"nope": {"kernel": np.zeros((2, 2), np.float32)}}}
        with pytest.raises(ValueError, match="swap_variables"):
            eng.swap_variables(bad, "b")
        assert eng.swap_variables(v1, "b") == "a"
        after = [eng.submit(s) for s in data]
        for s, f in zip(data, after):
            res = f.result(timeout=120)
            assert f.model_version == "b"
            want = fresh.forward_single(s, bucket=f.bucket)
            for a, b in zip(res, want):
                np.testing.assert_array_equal(a, b)
        assert all(f.model_version == "a" for f in before)
        assert eng.capture_ms == captured
        assert eng.stats()["captures"] == len(eng.buckets)


@pytest.mark.cuda
def test_engine_failed_batch_then_healthy_batch_bitwise(cuda_device):
    """An injected dispatch fault, then a replay that raises after the
    static batch was filled: each fails only its own futures, and the
    next batch on the same bucket equals forward_single bitwise; the
    dispatcher stays alive and the breaker closed."""
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    from hydragnn_tpu_torch.utils.faults import (InjectedFault,
                                                 install_fault_plan,
                                                 parse_fault_plan)
    data, mcfg, model_for, v0, _ = _lj_engine_parts(cuda_device, 6)
    eng = InferenceEngine(model_for(v0), mcfg, reference_samples=data,
                          max_batch_size=1, max_wait_ms=0.0,
                          ef_forward=True, breaker_threshold=3,
                          device=cuda_device)
    try:
        eng.warmup()
        install_fault_plan(parse_fault_plan("serving-dispatch@0"))
        with pytest.raises(InjectedFault):
            eng.submit(data[0]).result(timeout=120)
        install_fault_plan(None)
        bucket = eng.buckets[0]
        cap = eng._graphs[bucket]
        real = cap.replay

        def broken_replay():
            cap.replay = real
            raise RuntimeError("replay failed")

        cap.replay = broken_replay
        with pytest.raises(RuntimeError, match="replay failed"):
            eng.submit(data[1]).result(timeout=120)
        for s in data[2:6]:
            f = eng.submit(s)
            res = f.result(timeout=120)
            for a, b in zip(res, eng.forward_single(s, bucket=f.bucket)):
                np.testing.assert_array_equal(a, b)
        health = eng.health()
        assert health["batch_failures"] == 2
        assert health["state"] == "closed" and health["dispatcher_alive"]
    finally:
        install_fault_plan(None)
        eng.shutdown()


@pytest.mark.cuda
def test_structure_session_on_the_card_keeps_its_bucket(cuda_device):
    """run_md through submit_structure on the card (216 LJ atoms, 10
    steps): the incremental and offline modes give the same trajectory
    bit for bit, nothing is captured after warm-up, and the first step's
    forces match the CPU engine's within rtol 1e-4 / atol 1e-5."""
    import copy
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.md.loop import (init_lattice, lj_md_config,
                                            maxwell_velocities, md_buckets,
                                            run_md)
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.preprocess.transforms import build_graph_sample
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)
    pos0, cell = init_lattice(6, 1.2, 0.05, seed=1)
    n = len(pos0)
    vel0 = maxwell_velocities(n, 0.3, seed=2)
    nf = np.ones((n, 1), np.float32)
    cfg = lj_md_config(num_gaussians=32)
    frame0 = build_graph_sample(nf, pos0, cfg, cell=cell, with_targets=False)
    done = tcfg.update_config(copy.deepcopy(cfg), [frame0])
    mcfg = tcfg.build_model_config(done)
    variables = random_flax_variables(create_model(mcfg, device="cpu"), 9)
    results = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = create_model(mcfg, device=dev)
        model.load_state_dict(load_jax_variables(variables))
        with InferenceEngine(model, mcfg,
                             buckets=md_buckets(n, frame0.num_edges),
                             proto_sample=frame0, max_batch_size=1,
                             max_wait_ms=0.0, structure_config=done,
                             ef_forward=True, device=dev) as eng:
            eng.warmup()
            results[dev.type] = eng.forward_single(frame0)
            if dev.type != "cuda":
                continue
            runs = [run_md(eng, done, pos0, vel0, cell, nf, steps=10,
                           dt=0.005, mode=mode, force_scale=0.1)
                    for mode in ("incremental", "offline")]
            assert eng.stats()["captures"] == 1
            assert eng.health()["structure_requests"] == 11
    inc, off = runs
    assert inc["energies"] == off["energies"]
    np.testing.assert_array_equal(inc["final_pos"], off["final_pos"])
    np.testing.assert_array_equal(inc["final_vel"], off["final_vel"])
    for a, b in zip(results["cuda"], results["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pbc,cap", [(True, 6), (False, None)],
                         ids=["pbc_cap6", "open_uncapped"])
def test_trajectory_farm_on_the_card_equals_run_md(cuda_device, pbc, cap):
    """The trajectory farm on the card (27 LJ atoms, hidden 4, T = 3, 24
    steps, 5 a dispatch, one CUDA graph): each trajectory equals run_md
    through the same engine bitwise in positions and velocities, energies
    within rtol 1e-9; T = 1 equals trajectory 0; a second run replays the
    same graph with no capture and gives the same result; the graph's
    replays count B3 and B4."""
    import copy
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.md.loop import (init_lattice, lj_md_config,
                                            maxwell_velocities, md_buckets,
                                            run_md)
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.preprocess.transforms import build_graph_sample
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)
    cfg = lj_md_config(radius=1.2, max_neighbours=cap, hidden_dim=4,
                       num_conv_layers=1, num_gaussians=8)
    cfg["NeuralNetwork"]["Architecture"][
        "periodic_boundary_conditions"] = pbc
    pos0, cell = init_lattice(3, 1.0, 0.05, seed=1)
    cell = cell if pbc else None
    n = len(pos0)
    nf = np.ones((n, 1), np.float32)
    frame0 = build_graph_sample(nf, pos0, cfg, cell=cell, with_targets=False)
    done = tcfg.update_config(copy.deepcopy(cfg), [frame0])
    mcfg = tcfg.build_model_config(done)
    model = create_model(mcfg, device=cuda_device)
    model.load_state_dict(load_jax_variables(random_flax_variables(
        create_model(mcfg, device="cpu"), 8)))
    T, S, dt = 3, 24, 0.004
    pos = np.stack([init_lattice(3, 1.0, 0.05, seed=100 + t)[0]
                    for t in range(T)])
    vel = np.stack([maxwell_velocities(n, 0.3 * (t + 1), seed=200 + t)
                    for t in range(T)])
    kw = dict(node_features=nf, cell=cell)
    with InferenceEngine(model, mcfg,
                         buckets=md_buckets(n, max(frame0.num_edges, 1)),
                         proto_sample=frame0, max_batch_size=1,
                         max_wait_ms=0.0, structure_config=done,
                         md_skin=0.3, ef_forward=True,
                         device=cuda_device) as eng:
        eng.warmup()
        farm = eng.trajectory_farm(dt=dt, skin=0.3, steps_per_dispatch=5)
        tk.reset_launch_counts()
        res = farm.run(pos, vel, S, **kw)
        counts = tk.launch_counts()
        again = farm.run(pos, vel, S, **kw)
        seqs = [run_md(eng, done, pos[t], vel[t], cell, nf, steps=S, dt=dt,
                       mode="incremental", skin=0.3) for t in range(T)]
        res1 = eng.trajectory_farm(dt=dt, skin=0.3, steps_per_dispatch=5
                                   ).run(pos[:1], vel[:1], S, **kw)
    assert res["fresh_compiles_run"] == 1 and again["fresh_compiles_run"] == 0
    (cap_graph,) = farm.graphs.values()
    assert counts["segment_sum"] >= cap_graph.launches["segment_sum"] * \
        res["dispatches"] > 0
    assert counts["filter_scatter"] > 0 and \
        counts["filter_scatter_backward"] > 0
    assert res["rebuild_swaps"] > 0
    for t, seq in enumerate(seqs):
        np.testing.assert_array_equal(res["final_pos"][t], seq["final_pos"])
        np.testing.assert_array_equal(res["final_vel"][t], seq["final_vel"])
        for key in ("energy_first", "energy_last"):
            np.testing.assert_allclose(float(res[key][t]), seq[key],
                                       rtol=1e-9, atol=0.0)
    for key in ("final_pos", "final_vel", "energy_first", "energy_last"):
        np.testing.assert_array_equal(again[key], res[key])
        np.testing.assert_array_equal(res1[key][0], res[key][0])


# ------------------------------------------------------------ the fleet --
# A ReplicaRouter of csce PNA engines (published width) on one card: its
# results against a single engine's, a restart under a live stream, and a
# compile-store hit in a fresh process that builds no kernel.

def _fleet_parts(dev, store):
    import json
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_molecules
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    from hydragnn_tpu_torch.utils.weights import (load_jax_variables,
                                                  random_flax_variables)
    data = synthetic_molecules(24, seed=2)
    with open(ROOT / "examples/csce/csce_gap.json") as fh:
        cfg = json.load(fh)
    cfg = tcfg.update_config(cfg, data[:16], data[16:20], data[20:])
    mcfg = tcfg.build_model_config(cfg)
    variables = random_flax_variables(create_model(mcfg, device="cpu"), 3)

    def factory(idx=0):
        model = create_model(mcfg, device=dev)
        model.load_state_dict(load_jax_variables(variables))
        return InferenceEngine(model, mcfg, reference_samples=data,
                               max_batch_size=8, max_wait_ms=2.0,
                               compile_store=store, device=dev)
    return data, factory


@pytest.mark.cuda
def test_fleet_on_the_card_equals_the_single_engine_bitwise(cuda_device,
                                                            tmp_path):
    """Two replicas sharing a compile store: replica 0 compiles fresh,
    replica 1 warms from the store; every routed result equals the single
    engine's forward on the bucket it was served on, bitwise, and the
    replicas' graphs launch the edge-list PNA kernel and segment_sum."""
    from hydragnn_tpu_torch.serving.fleet import ReplicaRouter
    from hydragnn_tpu_torch.utils.devices import CompileStore
    store = CompileStore(str(tmp_path / "store"))
    data, factory = _fleet_parts(cuda_device, store)
    with factory() as single, ReplicaRouter(factory, 2) as router:
        reports = router.warmup()
        assert reports[0]["fresh"] == reports[0]["compiled"] > 0
        assert reports[1]["store_hits"] == reports[1]["compiled"]
        assert reports[1]["fresh"] == 0
        assert all(r["captures"] == len(single.buckets) for r in reports)
        tk.reset_launch_counts()
        futs = [router.submit(s) for s in data * 3]
        results = [f.result(timeout=120) for f in futs]
        counts = tk.launch_counts()
        assert counts["pna_edge_aggregate"] > 0 and counts["segment_sum"] > 0
        assert {f.replica for f in futs} == {0, 1}
        for s, fut, res in zip(data * 3, futs, results):
            want = single.forward_single(s, bucket=fut.bucket)
            for a, b in zip(res, want):
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_fleet_restart_under_a_live_stream_on_the_card(cuda_device,
                                                       tmp_path):
    """A stream from another thread while a replica is killed and
    restarted three times (each restart captures next to the other
    replica's replays): no future fails, each resolves once, every
    restart warms from the store, and the reserved memory stays within
    one replica's ladder of its value after the first cycle."""
    import threading
    import time
    from hydragnn_tpu_torch.serving.fleet import ReplicaRouter
    from hydragnn_tpu_torch.utils.devices import CompileStore
    store = CompileStore(str(tmp_path / "store"))
    data, factory = _fleet_parts(cuda_device, store)
    torch.cuda.empty_cache()
    start = torch.cuda.memory_reserved(cuda_device)
    with ReplicaRouter(factory, 2) as router:
        router.warmup()
        # one replica's model, graphs and pool
        ladder = (torch.cuda.memory_reserved(cuda_device) - start) / 2
        futs, stop = [], threading.Event()

        def stream():
            i = 0
            while not stop.is_set():
                futs.append(router.submit(data[i % len(data)]))
                i += 1
                time.sleep(0.0005)
        t = threading.Thread(target=stream)
        t.start()
        reserved, reports = [], []
        try:
            for _ in range(3):
                time.sleep(0.2)
                router.kill_replica(1)
                reports.append(router.restart_replica(1))
                time.sleep(0.2)
                reserved.append(torch.cuda.memory_reserved(cuda_device))
        finally:
            stop.set()
            t.join()
        for f in futs:
            assert f.exception(timeout=120) is None
        assert router.requests_done == len(futs)
        assert all(r["fresh"] == 0 and r["store_hits"] == r["compiled"]
                   for r in reports)
        assert reserved[-1] - reserved[0] <= ladder, (start, ladder,
                                                      reserved)


@pytest.mark.cuda
def test_compile_store_hit_in_a_fresh_build_root_runs_no_nvcc(cuda_device,
                                                              tmp_path):
    """A process whose kernel build root is empty warms a replica from a
    populated store: the libraries come from the store, no nvcc runs,
    and its results equal this process's bitwise."""
    import subprocess
    import sys
    from hydragnn_tpu_torch.utils.devices import CompileStore
    store_dir = tmp_path / "store"
    data, factory = _fleet_parts(cuda_device, CompileStore(str(store_dir)))
    with factory() as engine:
        engine.warmup()
        want = [engine.forward_single(s, bucket=engine.buckets[-1])[0]
                for s in data[:4]]
    code = f"""
import importlib.util, sys, pathlib
sys.path.insert(0, {str(ROOT)!r})
import numpy as np, torch
from hydragnn_tpu_torch.kernels import _build
_build.BUILD_ROOT = pathlib.Path({str(tmp_path / "empty")!r})
spec = importlib.util.spec_from_file_location("card_tests", {__file__!r})
card_tests = importlib.util.module_from_spec(spec)
spec.loader.exec_module(card_tests)
_fleet_parts = card_tests._fleet_parts
from hydragnn_tpu_torch.utils.devices import CompileStore
data, factory = _fleet_parts(torch.device("cuda"),
                             CompileStore({str(store_dir)!r}))
with factory() as engine:
    engine.warmup()
    st = engine.stats()
    got = [engine.forward_single(s, bucket=engine.buckets[-1])[0]
           for s in data[:4]]
np.save({str(tmp_path / "got.npy")!r}, np.stack(got))
print(_build.nvcc_runs, st["compile_fresh"], st["compile_store_hits"],
      st["compile_count"])
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    nvcc, fresh, hits, compiled = map(int, out.stdout.split()[-4:])
    assert (nvcc, fresh) == (0, 0) and hits == compiled > 0
    np.testing.assert_array_equal(np.load(tmp_path / "got.npy"),
                                  np.stack(want))


# ----------------------------------- DimeNet, PAINN, PNAEq and MACE (A7) --
# The last four architectures at LJ.json's layout cut to hidden 16: their
# [E, 3, F] and [E, mul, 2l+1] sums through the segment-sum kernel, the
# energy-force forward card vs CPU, and the captured energy-force steps
# against the eager ones.

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(700, 3, 32), (700, 32, 3), (700, 8, 5)],
                         ids=["vector", "mace_l1", "mace_l2"])
def test_vector_segment_sums_run_the_kernel_bitwise(cuda_device, shape):
    """ops.segment.segment_sum of [E, ...] rows on the card: one launch
    of the segment-sum kernel on [E, prod(...)] rows, bitwise the plain
    version's value and gradient on dyadic data (every sum exact in any
    order, so the card's atomic plain scatter gives the same bits)."""
    from hydragnn_tpu_torch.ops import segment as oseg
    rng = np.random.RandomState(5)
    data = _t((rng.randint(-8, 9, shape) / 4.0).astype(np.float32)).to(
        cuda_device).requires_grad_(True)
    ids = _t(rng.randint(-1, 41, shape[0]).astype(np.int32)).to(cuda_device)
    mask = _t(rng.rand(shape[0]) > 0.2).to(cuda_device)
    before = tk.launch_counts()["segment_sum"]
    got = oseg.segment_sum(data, ids, 40, mask)
    assert tk.launch_counts()["segment_sum"] == before + 1
    keep = mask.view(-1, *[1] * (len(shape) - 1))
    want = segment.segment_sum_plain(
        torch.where(keep, data, torch.zeros_like(data)), ids, 40)
    assert got.shape == (40,) + shape[1:]
    assert torch.equal(got, want)
    cot = _t((rng.randint(-8, 9, got.shape) / 8.0).astype(np.float32)).to(
        cuda_device)
    (g1,) = torch.autograd.grad(torch.sum(got * cot), data)
    (g2,) = torch.autograd.grad(torch.sum(want * cot), data)
    assert torch.equal(g1, g2)


A7_MODELS = ("DimeNet", "PAINN", "PNAEq", "MACE")


def _a7_setup(model_type, dense, n=12):
    """(model config, train config, loader batches on the host) of
    LJ.json with `model_type` (equivariance on but for DimeNet; MACE's
    keys as LJ.json has them) at hidden 16, batches of 4 cells, DimeNet's
    with their triplet tables."""
    import copy
    import json
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import lj_configurations
    from hydragnn_tpu_torch.graphs.triplets import maybe_triplet_transform
    from hydragnn_tpu_torch.models.create import data_input_dim
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    data = lj_configurations(n, seed=4)
    with open(ROOT / "examples/LennardJones/LJ.json") as fh:
        cfg = json.load(fh)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(model_type=model_type, hidden_dim=16, num_filters=16,
                neighbor_format=dense, equivariance=model_type != "DimeNet")
    arch["output_heads"]["node"]["dim_headlayers"] = [16, 16]
    cfg = tcfg.update_config(copy.deepcopy(cfg), data)
    loader = create_dataloaders(
        data, [], [], 4, neighbor_format=dense,
        batch_transform=maybe_triplet_transform(model_type, data, 4))[0]
    loader.set_epoch(0)
    return (data_input_dim(tcfg.build_model_config(cfg), data),
            cfg["NeuralNetwork"]["Training"], list(loader))


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "edge"])
@pytest.mark.parametrize("model_type", A7_MODELS)
def test_a7_energies_and_forces_card_match_cpu(cuda_device, model_type,
                                               dense):
    """One model's energies and real-node forces (forces through the
    kernels' differentiable Functions) on the card against the same
    weights on the CPU within rtol 1e-4 / atol 1e-5, with the segment-sum
    kernel launched."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
    mcfg, _, batches = _a7_setup(model_type, dense)
    batch = batches[0]
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        model = create_model(mcfg, device=dev, seed=2)
        before = tk.launch_counts()["segment_sum"]
        e, f = energy_forces_from_node_head(model, batch.to(dev))
        outs.append((e.cpu()[batch.graph_mask], f.cpu()[batch.node_mask],
                     tk.launch_counts()["segment_sum"] - before))
    (e1, f1, n1), (e2, f2, _) = outs
    assert n1 > 0 and torch.isfinite(f1).all()
    assert float(f2.abs().max()) > 0
    torch.testing.assert_close(e1, e2, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(f1, f2, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "edge"])
def test_dimenet_energy_force_gradient_nonfinite_where_cpu_is(cuda_device,
                                                              dense):
    """DimeNet's energy-force semantics on the card are the CPU's (and so
    the JAX package's, tests/test_torch_dimenet.py): the real nodes'
    forces finite, the padding node's not, and the energy-force loss and
    its parameter gradients non-finite in the same entries on both
    devices. The padding triplets' gradient rows reach the padding edge
    through the triplet gathers' layouts, as on the CPU."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train import train_step as tstep
    from hydragnn_tpu_torch.train.loss import energy_forces_from_node_head
    mcfg, _, batches = _a7_setup("DimeNet", dense)
    batch = batches[0]
    assert not bool(batch.triplet_mask.all())
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        model = create_model(mcfg, device=dev, seed=2)
        b = batch.to(dev)
        _, f = energy_forces_from_node_head(model, b)
        model.train()
        total, _ = tstep.make_loss_fn(model, mcfg, "mae",
                                      compute_grad_energy=True)(b)
        grads = torch.autograd.grad(total, list(model.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
        runs.append((torch.isfinite(f.detach()).cpu(),
                     bool(torch.isfinite(total)),
                     [torch.isfinite(g).cpu() for g in grads]))
    (f1, t1, g1), (f2, t2, g2) = runs
    real = batch.node_mask.view(-1, *[1] * (f1.dim() - 1)).expand_as(f1)
    assert bool(f1[real].all()) and not bool(f1[~real].all())
    assert torch.equal(f1, f2)
    assert not t1 and not t2
    assert sum(int((~g).sum()) for g in g1) > 0
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "edge"])
@pytest.mark.parametrize("model_type", ["PAINN", "PNAEq", "MACE"])
def test_a7_captured_ef_steps_equal_eager_steps_bitwise(cuda_device,
                                                       model_type, dense):
    """Three eager energy-force SGD steps against three captured single
    steps from the same state on the same batches: metrics, parameters
    and optimizer slots bitwise; one graph replayed."""
    from hydragnn_tpu_torch.train import train_step as tstep
    mcfg, train_cfg, batches = _a7_setup(model_type, dense)
    train_cfg = dict(train_cfg, Optimizer={"type": "SGD",
                                           "learning_rate": 1e-3})
    batches = [b.to(cuda_device) for b in batches]
    runs = []
    for graphed in (False, True):
        model, tx, state = _fresh_state(cuda_device, mcfg, train_cfg)
        step = tstep.make_train_step(model, mcfg, tx,
                                     **_step_kwargs(train_cfg))
        losses = []
        for b in batches:
            state, m = (step if graphed else step.eager)(state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs.append((losses, _host_state(state), len(step.steps.graphs)))
    (la, sa, _), (lb, sb, graphs) = runs
    assert np.isfinite(la).all() and la == lb
    _assert_same_state(sa, sb)
    assert graphs == 1


# ------------------------------------------------- the int8 tier and remat

@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,out", [(9, 12, 5), (33, 200, 200),
                                           (16, 13, 8), (17, 1, 8)])
def test_int8_dense_on_the_card_equals_the_cpu_bitwise(cuda_device, rows,
                                                       cols, out):
    """quant/ptq.int8_dense through `torch._int_mm` on the card, its
    operands zero-padded to the GEMM's shapes (more than 16 rows, inner
    and outer widths multiples of 8): x_q, w_q, s_w, the int32
    accumulator and y bitwise the CPU's `_int_mm` route."""
    from hydragnn_tpu_torch.quant.ptq import (int8_dense, int_mm,
                                              quantize_input,
                                              quantize_weight)
    rng = np.random.RandomState(rows * cols)
    x = _t((rng.randn(rows, cols) * 2).astype(np.float32))
    w = _t(rng.randn(out, cols).astype(np.float32))
    b = _t(rng.randn(out).astype(np.float32))
    s_x = x.abs().amax(0) / 127
    got, want = [], []
    for dev, sink in ((cuda_device, got), (torch.device("cpu"), want)):
        xs, ws, ss, bs = (t.to(dev) for t in (x, w, s_x, b))
        x_q = quantize_input(xs, ss)
        w_q, s_w = quantize_weight(ws, ss)
        sink += [x_q, w_q, s_w, int_mm(x_q, w_q.t()),
                 int8_dense(xs, ws, bs, ss)]
    for name, g, c in zip(("x_q", "w_q", "s_w", "acc", "y"), got, want):
        assert g.dtype == c.dtype and g.shape == c.shape, name
        assert torch.equal(g.cpu(), c), name


def _csce_int8_parts(dev):
    """A csce PNA engine's model (hidden 200, seeded weights) and
    molecules, calibrated on the card."""
    from hydragnn_tpu_torch.quant import calibrate
    data, factory = _fleet_parts(dev, None)
    eng = factory()
    model, mcfg = eng.model, eng.mcfg
    eng.shutdown()
    return data, model, mcfg, calibrate(model, None, mcfg, data,
                                        num_samples=8)


@pytest.mark.cuda
def test_int8_bucket_graph_equals_its_eager_forward(cuda_device):
    """An int8 engine's bucket graph replays bitwise the eager quantized
    forward of the same batch, and batched = single within a bucket."""
    from hydragnn_tpu_torch.serving.engine import InferenceEngine
    data, model, mcfg, calib = _csce_int8_parts(cuda_device)
    with InferenceEngine(model, mcfg, reference_samples=data,
                         max_batch_size=8, compute_dtype="int8",
                         quant_calibration=calib,
                         device=cuda_device) as eng:
        eng.warmup()
        futs = [eng.submit(s) for s in data]
        res = [f.result(timeout=120) for f in futs]
        for s, f, r in zip(data, futs, res):
            assert f.tier == "int8" and f.parity == "tolerance"
            single = eng.forward_single(s, bucket=f.bucket)
            np.testing.assert_array_equal(r[0], single[0])
        assert eng.stats()["captures"] == len(eng.buckets)
        for s in data[:4]:
            bucket = futs[0].bucket
            replayed = eng.forward_single(s, bucket=bucket)
            eager = eng._run(eng._collate_bucket([s], bucket).to(
                cuda_device))
            np.testing.assert_array_equal(replayed[0],
                                          eager[0].cpu().numpy()[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pna_dense", "pna_edge"])
def test_conv_checkpointing_captured_equals_eager_bitwise(cuda_device, kind):
    """Three csce PNA steps with Training.conv_checkpointing, eager and
    captured, from one state on the same batches: metrics, parameters and
    optimizer slots bitwise, and bitwise the steps without remat."""
    import dataclasses
    from hydragnn_tpu_torch.train import train_step as tstep
    mcfg, train_cfg, batches = _step_setup(cuda_device, kind)
    train_cfg = dict(train_cfg, Optimizer={"type": "SGD",
                                           "learning_rate": 1e-3})
    runs = []
    for remat, graphed in ((False, False), (True, False), (True, True)):
        cfg = dataclasses.replace(mcfg, conv_checkpointing=remat)
        model, tx, state = _fresh_state(cuda_device, cfg, train_cfg)
        step = tstep.make_train_step(model, cfg, tx,
                                     **_step_kwargs(train_cfg))
        losses = []
        for b in batches[:3]:
            state, m = (step if graphed else step.eager)(state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs.append((losses, _host_state(state)))
    (l0, s0), (l1, s1), (l2, s2) = runs
    assert np.isfinite(l0).all() and l0 == l1 == l2
    _assert_same_state(s0, s1)
    _assert_same_state(s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,node_arch", [
    ("GIN", "mlp_per_node"), ("PNA", "conv"), ("PAINN", "conv")])
def test_node_heads_card_match_cpu(cuda_device, model_type, node_arch):
    """A node head of each new type on the lattice, card against CPU from
    the same weights: the training-mode output within SUM_TOL; the
    parameter gradients within 1e-3 relative L2 as one vector, and within
    1e-2 (the smoke's card-vs-plain gradient bound) each tensor that
    carries at least 1 % of the norm (the others are cancellation noise:
    a bias before a training-mode batch norm has a gradient of 0); the
    bank's and the convs' gradients go through the segment-sum kernel on
    the card."""
    import copy
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs import batch as tbatch
    from hydragnn_tpu_torch.graphs.synthetic import bcc_lattices
    from hydragnn_tpu_torch.models.create import create_model
    samples = bcc_lattices(12, seed=0, heads=("node",))
    if node_arch == "mlp_per_node":
        sizes = [s.num_nodes for s in samples]
        modal = max(set(sizes), key=sizes.count)
        samples = [s for s in samples if s.num_nodes == modal]
    cfg = _lattice_node_config(model_type, node_arch)
    cfg = tcfg.update_config(copy.deepcopy(cfg), samples)
    mcfg = tcfg.build_model_config(cfg)
    batch = tbatch.collate(samples)
    c = torch.randn(batch.num_nodes, 1, generator=torch.Generator()
                    .manual_seed(0))
    runs = []
    for dev in (torch.device("cpu"), cuda_device):
        model = create_model(mcfg, device=dev, seed=1).train()
        tk.reset_launch_counts()
        (out,), _ = model(batch.to(dev))
        grads = torch.autograd.grad(torch.sum(out * c.to(dev)),
                                    list(model.parameters()),
                                    allow_unused=True,
                                    materialize_grads=True)
        torch.cuda.synchronize()
        runs.append((out.detach().cpu(), [g.cpu() for g in grads],
                     tk.launch_counts()))
    (o_cpu, g_cpu, _), (o_gpu, g_gpu, counts) = runs
    real = batch.node_mask
    torch.testing.assert_close(o_gpu[real], o_cpu[real], **SUM_TOL)
    whole = torch.cat([b.reshape(-1) for b in g_cpu]).norm()
    gap = torch.cat([(a - b).reshape(-1) for a, b in zip(g_gpu, g_cpu)])
    assert float(gap.norm() / whole) <= 1e-3
    for a, b in zip(g_gpu, g_cpu):
        if b.norm() >= 1e-2 * whole:
            assert float((a - b).norm() / b.norm()) <= 1e-2
    assert counts["segment_sum"] > 0


def _lattice_node_config(model_type, node_arch):
    """tests/utils.make_config's lattice config (hidden 8, 2 layers) with
    one node head [4, 4] of type `node_arch`, without the JAX package."""
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "unit_test", "format": "unit_test",
            "node_features": {"name": ["x", "x2", "x3"], "dim": [1, 1, 1],
                              "column_index": [0, 6, 7]}},
        "NeuralNetwork": {
            "Architecture": {
                "model_type": model_type, "radius": 1.0,
                "max_neighbours": 100, "num_radial": 6, "hidden_dim": 8,
                "num_conv_layers": 2, "equivariance": False,
                "output_heads": {"node": {
                    "num_headlayers": 2, "dim_headlayers": [4, 4],
                    "type": node_arch}},
                "task_weights": [1.0]},
            "Variables_of_interest": {
                "input_node_features": [0], "output_names": ["x"],
                "output_index": [0], "type": ["node"],
                "denormalize_output": False},
            "Training": {
                "num_epoch": 1, "perc_train": 0.7, "batch_size": 32,
                "loss_function_type": "mse",
                "Optimizer": {"type": "AdamW", "learning_rate": 0.005}}}}


@pytest.fixture
def world_one_group(tmp_path):
    """A world-1 gloo process group for the test (file rendezvous),
    destroyed after it."""
    import torch.distributed as dist
    from hydragnn_tpu_torch.parallel.mesh import init_distributed
    assert init_distributed(coordinator=f"file://{tmp_path}/rdzv",
                            num_processes=1, process_id=0, timeout_s=60,
                            backend="gloo", device="cuda") == (1, 0)
    yield
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("accumulate", [1, 2])
@pytest.mark.parametrize("kind", ["pna_dense", "pna_edge", "schnet"])
def test_spmd_captured_steps_equal_eager_and_single_device_steps(
        cuda_device, world_one_group, kind, accumulate):
    """The SPMD step of a world-1 group on the card: its graphs (forward +
    backward, then the all-reduce between, then the update; one update
    graph per accumulation phase) bitwise its eager parts and bitwise the
    single-device step's replays, step by step: metrics, every parameter,
    running statistic and optimizer slot; the launch counters alike."""
    from hydragnn_tpu_torch.parallel.spmd import SpmdTrainStep
    from hydragnn_tpu_torch.train import train_step as tstep
    dev = cuda_device
    mcfg, train_cfg, batches = _step_setup(dev, kind, "float32",
                                           accumulate=accumulate)
    kw = _step_kwargs(train_cfg)
    runs = []
    for route in ("eager", "captured", "single"):
        model, tx, state = _fresh_state(dev, mcfg, train_cfg)
        if route == "single":
            step = tstep.make_train_step(model, mcfg, tx, **kw)
        else:
            spmd = SpmdTrainStep(model, mcfg, tx, **kw)
            step = spmd.eager if route == "eager" else spmd
        losses = []
        for i, b in enumerate(batches[:5]):
            if i == 3:      # past the captures and their warm-up runs
                tk.reset_launch_counts()
            state, m = step(state, b)
            losses.append((float(m["loss"]), float(m["nonfinite_steps"])))
        torch.cuda.synchronize()
        runs.append((losses, _host_state(state), tk.launch_counts()))
    (la, sa, ca), (lb, sb, cb), (lc, sc, cc) = runs
    assert la == lb == lc
    _assert_same_state(sa, sb)
    _assert_same_state(sa, sc)
    assert ca == cb == cc and sum(ca.values()) > 0


def _pipeline_setup(dev, kind, stages=2, micro=2):
    """(model, tx, state) of a pipelined csce PNA (dense or edge list) or
    LJ SchNet EF (edge list) over `stages` streams of one card, its
    LayerNorm stack at the config's width, and 3 stacked batches of 4
    graphs (`micro` microbatches)."""
    from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.train import optimizer as topt
    from hydragnn_tpu_torch.train import train_step as tstep
    from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                     synthetic_molecules)
    mcfg, train_cfg, _ = _step_setup(dev, kind)
    data = (lj_configurations(36, seed=1) if kind == "schnet"
            else synthetic_molecules(36, seed=1))
    splits = (data[:28], data[28:32], data[32:])
    loader = create_dataloaders(*splits, 4, neighbor_format=kind ==
                                "pna_dense", num_shards=micro)[0]
    batches = [b.to(dev) for b in loader][:3]
    model = tpt.create_pipeline_model(mcfg, [torch.device("cuda", 0)]
                                      * stages, seed=3)
    train_cfg = dict(train_cfg, Optimizer={"type": "SGD",
                                           "learning_rate": 1e-3})
    tx = topt.select_optimizer(train_cfg)
    return model, tx, tstep.TrainState.create(model, tx), batches, \
        train_cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["pna_dense", "pna_edge", "schnet"])
@pytest.mark.parametrize("schedule,remat", [("gpipe", None),
                                            ("1f1b", "full"),
                                            ("1f1b", "dots")])
def test_pipeline_captured_steps_equal_eager_bitwise(cuda_device, kind,
                                                     schedule, remat):
    """Three pipelined steps on two streams of the card, eager and
    captured (the stage streams fork from the capture stream and join
    back): metrics and state bitwise; the kernels launched inside the
    stages (B1 or B2 and their backwards, or B4 and its dh)."""
    from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
    runs = []
    for graphed in (False, True):
        model, tx, state, batches, tcfg = _pipeline_setup(cuda_device,
                                                          kind)
        make = (tpt.make_pipeline_ef_train_step
                if tcfg.get("compute_grad_energy")
                else tpt.make_pipeline_train_step)
        step = make(model, tx, tcfg["loss_function_type"],
                    schedule=schedule, remat=remat is not None,
                    remat_policy=remat)
        tk.reset_launch_counts()
        losses = []
        for b in batches:
            state, m = (step if graphed else step.eager)(state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs.append((losses, _host_state(state), tk.launch_counts()))
    (l0, s0, c0), (l1, s1, c1) = runs
    assert np.isfinite(l0).all() and l0 == l1
    _assert_same_state(s0, s1)
    names = {"pna_dense": ("nbr_aggregate", "nbr_aggregate_backward"),
             "pna_edge": ("pna_edge_aggregate",
                          "pna_edge_aggregate_backward"),
             "schnet": ("filter_scatter", "filter_scatter_backward")}[kind]
    for name in names + ("segment_sum",):
        assert c0[name] > 0 and c1[name] > 0, name


@pytest.mark.cuda
def test_pipeline_streams_equal_one_stream_and_sequential(cuda_device):
    """The deep tick schedule on 4 streams of the card, on one stream,
    and the sequential stack: the same forward, bit for bit, and the same
    step's parameters."""
    from hydragnn_tpu_torch.datasets.loader import unstack_batch
    from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
    model, tx, state, batches, tcfg = _pipeline_setup(
        cuda_device, "pna_edge", stages=2, micro=4)
    micros = unstack_batch(batches[0])
    with torch.no_grad():
        outs = [tpt.make_pipeline_forward(model, pipelined=p,
                                          stage_streams=st)(micros)
                for p, st in ((True, True), (True, False), (False, True))]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a[0][0], b[0][0])
    after = []
    for st in (True, False):
        snap = state.copy()
        step = tpt.make_pipeline_train_step(model, tx, schedule="1f1b",
                                            stage_streams=st)
        step(state, batches[0])
        torch.cuda.synchronize()
        after.append(_host_state(state))
        state.restore(snap)
    _assert_same_state(after[0], after[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,data,zero", [("pna_edge", 1, False),
                                            ("pna_edge", 2, True),
                                            ("gin_edge", 2, False),
                                            ("schnet", 1, False)])
def test_composed_captured_steps_equal_eager_bitwise(cuda_device, kind, data,
                                                     zero):
    """Three composed (data x graph) steps with graph_shards 2 on streams
    of the card, eager and captured (the slot streams fork from the
    capture stream and join back): metrics and state bitwise; B3 launched
    in the shards (B4 and its dh for SchNet), no fused PNA kernel."""
    from hydragnn_tpu_torch.parallel import composite
    from hydragnn_tpu_torch.preprocess.load_data import create_dataloaders
    from hydragnn_tpu_torch.graphs.synthetic import (lj_configurations,
                                                     qm9_molecules,
                                                     synthetic_molecules)
    mcfg, train_cfg, _ = _step_setup(cuda_device, kind)
    samples = {"schnet": lj_configurations, "gin_edge": qm9_molecules,
               "pna_edge": synthetic_molecules}[kind](36, seed=1)
    loader = create_dataloaders(samples[:28], samples[28:32], samples[32:],
                                8, neighbor_format=False,
                                num_shards=data)[0]
    batches = [b.to(cuda_device) for b in loader][:3]
    runs = []
    for graphed in (False, True):
        model, tx, state = _fresh_state(cuda_device, mcfg, dict(
            train_cfg, Optimizer={"type": "AdamW", "learning_rate": 1e-3}))
        grid = composite.ComposedGrid([cuda_device] * (2 * data), data, 2)
        step = composite.make_composed_train_step(
            model, mcfg, tx, grid, zero_opt=zero, zero_min_size=1024,
            **_step_kwargs(train_cfg))
        tk.reset_launch_counts()
        losses = []
        for b in batches:
            state, m = (step if graphed else step.eager)(state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs.append((losses, _host_state(state), tk.launch_counts()))
    (l0, s0, c0), (l1, s1, c1) = runs
    assert np.isfinite(l0).all() and l0 == l1
    _assert_same_state(s0, s1)
    for c in (c0, c1):
        assert c["segment_sum"] > 0
        assert c["pna_edge_aggregate"] == 0 and c["nbr_aggregate"] == 0
        if kind == "schnet":
            assert c["filter_scatter"] > 0
            assert c["filter_scatter_backward"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("zero", [False, True])
def test_pipe_by_data_captured_steps_equal_eager_bitwise(cuda_device, zero):
    """Three steps of 2 stages x 2 data shards (4 streams of the card),
    eager and captured: metrics and state bitwise; B1 and its backward
    launched inside the stages."""
    from hydragnn_tpu_torch.parallel import pipeline_trainer as tpt
    from hydragnn_tpu_torch.train import optimizer as topt
    from hydragnn_tpu_torch.train import train_step as tstep
    runs = []
    for graphed in (False, True):
        model, _, _, batches, tcfg = _pipeline_setup(
            cuda_device, "pna_dense", micro=4)
        tx = topt.select_optimizer({"Optimizer": {"type": "AdamW",
                                                  "learning_rate": 1e-3}})
        state = tstep.TrainState.create(model, tx)
        step = tpt.make_pipeline_train_step(
            model, tx, tcfg["loss_function_type"], schedule="1f1b",
            data_shards=2, zero_opt=zero, zero_min_size=1024)
        tk.reset_launch_counts()
        losses = []
        for b in batches:
            state, m = (step if graphed else step.eager)(state, b)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        runs.append((losses, _host_state(state), tk.launch_counts()))
    (l0, s0, c0), (l1, s1, c1) = runs
    assert np.isfinite(l0).all() and l0 == l1
    _assert_same_state(s0, s1)
    for name in ("nbr_aggregate", "nbr_aggregate_backward"):
        assert c0[name] > 0 and c1[name] > 0, name


@pytest.mark.cuda
def test_graph_parallel_layers_on_streams_equal_single_device(cuda_device):
    """The edge-sharded and ring layers on 4 streams of the card against
    the single-device segment sum: bitwise on dyadic data, forward and
    VJP, B3 launched in every slot."""
    from hydragnn_tpu_torch.parallel import graph_parallel as gp
    n, e, f, D = 4096, 65536, 16, 4
    rng = np.random.default_rng(0)
    send = rng.integers(0, n, e).astype(np.int32)
    recv = rng.integers(0, n, e).astype(np.int32)
    x = torch.from_numpy((rng.integers(-16, 17, (n, f)) / 8.0).astype(
        np.float32)).to(cuda_device)
    ct = torch.from_numpy((rng.integers(-8, 9, (n, f)) / 8.0).astype(
        np.float32)).to(cuda_device)

    def msg(xi, xj, ea):
        return xj * 2.0 + xi * 0.5
    xs = x.clone().requires_grad_(True)
    st, rt = (torch.from_numpy(a).long().to(cuda_device)
              for a in (send, recv))
    want = segment.segment_sum(msg(segment.gather_rows(xs, rt),
                                   segment.gather_rows(xs, st), None)
                               .contiguous(), rt, n)
    (want_g,) = torch.autograd.grad(want, xs, ct)
    mask, send_s, recv_s = gp.shard_edge_arrays(D, send, recv)
    layer = gp.make_edge_sharded_layer([cuda_device] * D, msg, n)
    xe = x.clone().requires_grad_(True)
    tk.reset_launch_counts()
    got = layer(xe, send_s, recv_s, mask)
    (got_g,) = torch.autograd.grad(got, xe, ct)
    layer.slots.join()
    torch.cuda.synchronize()
    assert tk.launch_counts()["segment_sum"] >= D
    assert torch.equal(got, want) and torch.equal(got_g, want_g)
    b = gp.build_ring_buckets(send, recv, n, D)
    ring = gp.make_ring_layer([cuda_device] * D, msg)
    xr = gp.shard_node_array(x, D).clone().requires_grad_(True)
    out = ring(xr, b.send_local, b.recv_local, b.mask)
    (gr,) = torch.autograd.grad(out, xr, gp.shard_node_array(ct, D))
    ring.slots.join()
    torch.cuda.synchronize()
    assert torch.equal(out.reshape(-1, f)[:n], want)
    assert torch.equal(gr.reshape(-1, f)[:n], want_g)


# -------------------------------------------------- GFM mixture (A9) --
def _gfm_setup(sizes, dyadic=False, seed=0):
    """The GFM example's members and config at a small width (hidden 8,
    2 layers)."""
    import json
    from hydragnn_tpu_torch.config import config as tcfg
    from hydragnn_tpu_torch.graphs.synthetic import build_members
    members = build_members(sizes=sizes, seed=seed, dyadic=dyadic)
    with open(Path(__file__).resolve().parents[1] / "examples" / "gfm" /
              "gfm_mixture.json") as fh:
        cfg = json.load(fh)
    arch = cfg["NeuralNetwork"]["Architecture"]
    arch.update(hidden_dim=8, num_conv_layers=2)
    arch["output_heads"]["graph"].update(dim_sharedlayers=8,
                                         dim_headlayers=[8, 8])
    done = tcfg.update_config(cfg, [s for v in members.values() for s in v])
    return members, tcfg.build_model_config(done)


@pytest.mark.cuda
def test_gfm_mixture_one_capture_zero_added_and_replays_bitwise(
        cuda_device):
    """A 2-member sub-mixture under the full mixture's pinned budget, then
    two epochs of the 3-member mixture, through one head-masked train
    step: one CUDA graph for the whole run (the third member adds none),
    and every replay (its static slot refilled with each batch's
    dataset_id) bitwise the eager step on a twin model."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.parallel.multidataset import GfmMixtureLoader
    from hydragnn_tpu_torch.train.gfm import make_gfm_train_step
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    from hydragnn_tpu_torch.train.train_step import TrainState
    dev = cuda_device
    members, mcfg = _gfm_setup((12, 8, 10))
    full = GfmMixtureLoader(members, 6, cfg=mcfg, seed=7)
    sub = GfmMixtureLoader({n: members[n] for n in ("alpha", "beta")}, 6,
                           seed=7, pack_budget=full.pack_budget)
    runs = []
    for _ in range(2):
        model = create_model(mcfg, device=dev, seed=1)
        tx = Optimizer("Adam", learning_rate=1e-3)
        runs.append((TrainState.create(model, tx),
                     make_gfm_train_step(model, mcfg, tx, num_datasets=3)))
    (state, step), (twin, twin_step) = runs
    sub.set_epoch(0)
    batches = [b.to(dev) for b in sub]
    for epoch in range(2):
        full.set_epoch(epoch)
        batches += [b.to(dev) for b in full]
    seen_sub = len(list(sub))
    for i, b in enumerate(batches):
        state, m = step(state, b)
        twin, tm = twin_step.eager(twin, b)
        assert torch.equal(m["loss"], tm["loss"]), i
        if i == seen_sub - 1:
            assert len(step.steps.graphs) == 1
    assert len(step.steps.graphs) == 1
    for k, v in state.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k


@pytest.mark.cuda
def test_gfm_head_masked_step_is_the_plain_step_on_the_card(cuda_device):
    """The head-masked captured step on one dyadic member with one-hot
    head weights equals the plain captured step bitwise in every
    parameter and running statistic (JAX's
    test_head_masked_step_bitwise_vs_plain contract, on the card)."""
    from hydragnn_tpu_torch.graphs.batch import BucketSpec, collate
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.train.gfm import apply_head_weights
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    from hydragnn_tpu_torch.train.train_step import (TrainState,
                                                     make_train_step)
    dev = cuda_device
    members, mcfg = _gfm_setup((6, 6, 6), dyadic=True, seed=1)
    for d, name in enumerate(sorted(members)):
        onehot = tuple(1.0 if i == d else 0.0 for i in range(3))
        b = collate(members[name], bucket=BucketSpec(multiple=64))
        ids = torch.where(b.graph_mask, torch.tensor(d, dtype=torch.int32),
                          torch.tensor(-1, dtype=torch.int32))
        out = []
        for batch in (b.replace(dataset_id=ids), b):
            model = create_model(mcfg, device=dev, seed=2)
            tx = Optimizer("SGD", learning_rate=0.5, momentum=0.0)
            state = TrainState.create(model, tx)
            step = make_train_step(model, apply_head_weights(mcfg, onehot),
                                   tx)
            for _ in range(3):      # warm-up, capture, replay
                state, m = step(state, batch.to(dev))
            assert len(step.steps.graphs) == 1
            out.append(({k: v.clone() for k, v in
                         state.state_dict().items()}, m))
        (s_gfm, m_gfm), (s_plain, m_plain) = out
        for k in s_plain:
            assert torch.equal(s_gfm[k], s_plain[k]), (name, k)
        assert torch.equal(m_gfm[f"task_{d}"], m_plain[f"task_{d}"])


def _sampled_setup(staleness_k, hidden=16, num_nodes=600):
    """A synthetic ogbn graph, its sampled loader (4 range partitions,
    rank 0 of 1: partitions 1-3 remote) and a SAGE config."""
    from hydragnn_tpu_torch.examples.ogbn import (complete_config,
                                                  load_ogbn_config)
    from hydragnn_tpu_torch.graphs.synthetic import synthetic_arxiv
    from hydragnn_tpu_torch.preprocess.sampling import NeighborSamplingLoader
    g = synthetic_arxiv(num_nodes=num_nodes, seed=2)
    config = load_ogbn_config()
    arch = config["NeuralNetwork"]["Architecture"]
    arch["hidden_dim"] = hidden
    arch["output_heads"]["node"]["dim_headlayers"] = [hidden, hidden]
    mcfg = complete_config(config, g)
    loader = NeighborSamplingLoader(
        x=g.x, y_node=g.y_onehot, senders=g.senders, receivers=g.receivers,
        train_nodes=g.train_idx, batch_size=32, fanouts=(10, 5), seed=0,
        num_partitions=4, staleness_k=staleness_k, num_layers=2,
        async_workers=0)
    return g, loader, mcfg


@pytest.mark.cuda
@pytest.mark.parametrize("staleness_k", [0, 3])
def test_sampled_step_one_capture_and_replays_bitwise(cuda_device,
                                                      staleness_k):
    """Two epochs of sampled SAGE steps, exact and historical with the
    refresh flag alternating (and at K's cadence in the second epoch):
    one CUDA graph for the run, every replay's metrics bitwise the eager
    step's on a twin model and twin tables, and at the end the parameters
    and the tables' real rows bitwise; the historical eval step likewise
    one capture and bitwise its eager body."""
    from hydragnn_tpu_torch.models.create import create_model
    from hydragnn_tpu_torch.preprocess.sampling import init_hist_tables
    from hydragnn_tpu_torch.train.optimizer import Optimizer
    from hydragnn_tpu_torch.train.train_step import (
        TrainState, make_sampled_eval_step, make_sampled_train_step)
    dev = cuda_device
    g, loader, mcfg = _sampled_setup(staleness_k)
    runs = []
    for _ in range(2):
        model = create_model(mcfg, device=dev, seed=1)
        tx = Optimizer("Adam", learning_rate=3e-3)
        tables = (init_hist_tables(g.x, mcfg.hidden_dim, 2, device=dev)
                  if staleness_k else None)
        runs.append((model, TrainState.create(model, tx), tables,
                     make_sampled_train_step(model, mcfg, tx,
                                             staleness_k=staleness_k)))
    (model, state, tables, step), (_, twin, twin_tables, twin_step) = runs
    i = 0
    for epoch in range(2):
        loader.set_epoch(epoch)
        for b in loader:
            b = b.to(dev)
            flag = (i % 2 == 0) if epoch == 0 else (i % staleness_k == 0
                                                    if staleness_k else 0)
            args = (tables, flag) if staleness_k else ()
            twin_args = (twin_tables, flag) if staleness_k else ()
            m = step(state, b, *args)[-1]
            tm = twin_step.eager(twin, b, *twin_args)[-1]
            assert sorted(m) == sorted(tm)
            for k in m:
                assert torch.equal(m[k], tm[k]), (i, k)
            i += 1
    assert len(step.steps.graphs) == 1
    for k, v in state.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
    if staleness_k:
        ng = g.num_nodes
        assert torch.equal(tables.layers[:, :ng], twin_tables.layers[:, :ng])
        assert torch.equal(tables.versions[:ng], twin_tables.versions[:ng])
        assert int((tables.versions[:ng] > 0).sum()) > 0
        ev = make_sampled_eval_step(model, mcfg, staleness_k=staleness_k)
        loader.set_epoch(0)
        b = next(iter(loader)).to(dev)
        for _ in range(3):
            m, out = ev(state, b, tables)
        me, oute = ev.eager(state, b, tables)
        assert len(ev.steps.graphs) == 1
        for k in m:
            assert torch.equal(m[k], me[k]), k
        assert torch.equal(out[0], oute[0])


@pytest.mark.cuda
def test_sampled_segment_sums_match_plain_versions(cuda_device):
    """B3 at a sampled batch's shapes (fanouts 10, 5; the padding node
    takes every masked edge): SAGE's mean by receivers and the sender
    gather's gradient, each over the layout the stack builds (masked
    edges left out), against the plain versions on the real rows; the
    layouts' kept rows are the real edges only."""
    from hydragnn_tpu_torch.kernels.segment import segment_layout
    dev = cuda_device
    _, loader, _ = _sampled_setup(0)
    b = next(iter(loader)).to(dev)
    n, keep = b.num_nodes, b.edge_mask
    assert not bool(keep.all())
    gen = torch.Generator(device=dev).manual_seed(0)
    for ids in (b.receivers, b.senders):
        layout = segment_layout(ids, n, keep)
        assert int(layout[0][-1]) == int(keep.sum())
        for f in (128, 64):
            data = torch.randn(b.num_edges, f, device=dev,
                               generator=gen) * keep[:, None]
            got = segment.segment_sum(data, ids, n, layout=layout)
            want = segment.segment_sum_plain(data, ids, n)
            real = b.node_mask
            np.testing.assert_allclose(got[real].cpu().numpy(),
                                       want[real].cpu().numpy(), **SUM_TOL)


@pytest.mark.cuda
def test_ogbn_driver_runs_on_the_card_by_default(cuda_device, tmp_path):
    """The driver with no --device trains on the card (one train step
    capture, B3 launched); with --device cpu on the CPU (no capture);
    the same plan either way."""
    from hydragnn_tpu_torch.examples import ogbn
    base = ["--num-nodes", "600", "--batch-size", "64", "--num-epochs", "1",
            "--async-workers", "0"]
    tk.reset_launch_counts()
    (tmp_path / "card").mkdir()
    card, info = ogbn.run(ogbn.parse_args(base + ["--job-dir",
                                                  str(tmp_path / "card")]))
    assert info.state.params["conv_0.lin_l.weight"].is_cuda
    assert info.train_captures == 1
    assert tk.launch_counts()["segment_sum"] > 0
    (tmp_path / "cpu").mkdir()
    cpu, cinfo = ogbn.run(ogbn.parse_args(
        base + ["--job-dir", str(tmp_path / "cpu"), "--device", "cpu"]))
    assert cinfo.train_captures == 0
    assert not cinfo.state.params["conv_0.lin_l.weight"].is_cuda
    assert card["plan_fp"] == cpu["plan_fp"]
    assert np.isfinite(card["history"]["train_loss"]).all()
