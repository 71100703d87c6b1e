"""The port's CUDA kernels against their plain PyTorch versions on the
card. These tests import no JAX (the machine with the card has none) and
skip without a CUDA device; run them there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX). Bounds as in
tests/test_torch_kernels.py: min/max/count exact, sums rtol/atol 2e-5.
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
                                  "pna_edge_aggregate": 1}
    with pytest.raises(TypeError):
        segment.segment_sum(data.double(), ids[:64], 64)
