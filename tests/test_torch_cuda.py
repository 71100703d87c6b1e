"""The port's CUDA kernels against their plain PyTorch versions on the
card. These tests import no JAX (the machine with the card has none) and
skip without a CUDA device; run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX). Bounds as in
tests/test_torch_kernels.py: min/max/count exact, sums rtol/atol 2e-5.
The autograd Functions (`segment_sum`'s, `filter_scatter`'s and
`gather_rows`') are held against autograd through the plain versions on
the same card: a gather or a product of the same two numbers is exact, a
sum (dh, a gather's gradient) within the sums' rtol/atol 2e-5.
"""
import numpy as np
import pytest
import torch

from hydragnn_tpu_torch import kernels as tk
from hydragnn_tpu_torch.kernels import fused_mp, nbr, segment

SUM_TOL = dict(rtol=2e-5, atol=2e-5)


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
                                  "filter_scatter_backward": 0}
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
