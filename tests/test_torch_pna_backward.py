"""The plain versions of the PNA backward kernels (csrc/pna_backward.cu)
on the CPU: the dense layout's statistics summed slot after slot, the
kernels' order (`ops/segment.sum_slots_in_order`, used by
`nbr_aggregate_plain` and `nbr_aggregate_vjp`), and the backward
wrappers' dispatch (`nbr_aggregate_bwd`, `pna_edge_bwd`: their plain
versions for CPU tensors, nothing built). tests/test_torch_train.py
holds the VJPs against the JAX package. On rows whose variance sits at
its rounding noise no order is the reference's: there the Pallas
kernel's std (interpret mode) differs from the plain forward's by up to
1.1 % (3.6e-5 at std = sqrt(eps)), and only the order is held.

Bounds: bitwise where the order is the point (a float32 reference in
slot order, which the kernels follow); float32 rtol/atol 2e-5 and bf16
one ulp against torch.sum's order.
"""
import numpy as np
import pytest
import torch

from hydragnn_tpu_torch import kernels as tk
from hydragnn_tpu_torch.graphs.synthetic import (tie_rich_edge_case,
                                                 tie_rich_neighbor_case)
from hydragnn_tpu_torch.kernels import _build, fused_mp, nbr
from hydragnn_tpu_torch.ops.segment import sum_accum_f32, sum_slots_in_order

# see tests/test_torch_train.py: one intra-op thread per test worker
torch.set_num_threads(1)

SUM_TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16_ulps(got, want):
    g, w = got.float(), want.float()
    scale = torch.maximum(torch.maximum(g.abs(), w.abs()),
                          torch.full_like(g, 2.0 ** -10))
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return float(((g - w).abs() / ulp).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sum_slots_in_order_is_a_sequential_float32_sum(dtype):
    """Slot after slot from 0 in float32, rounded once to the dtype: a
    numpy loop in that order, bitwise; within one ulp (bf16) or SUM_TOL
    of torch.sum's order."""
    rng = np.random.RandomState(1)
    data = _t(rng.randn(30, 11, 7).astype(np.float32)).to(dtype)
    got = sum_slots_in_order(data)
    acc = np.zeros((30, 7), np.float32)
    for k in range(11):
        acc = acc + data[:, k].float().numpy()
    assert got.dtype == dtype
    assert torch.equal(got, _t(acc).to(dtype))
    other = sum_accum_f32(data, 1)
    if dtype == torch.float32:
        torch.testing.assert_close(got, other, **SUM_TOL)
    else:
        assert _bf16_ulps(got, other) <= 1.0


def test_plain_versions_follow_the_slot_order_on_constant_rows():
    """Rows whose 3-24 slots carry one non-dyadic message: var = sq / c -
    mean^2 lands at 0 or a rounding step either side, and the order of
    the sums picks the branch of the std's gradient (1, 1/2, 0). Against
    a float32 reference summed slot after slot: the plain forward's mean
    bitwise and its std within one ulp (torch's CPU sqrt may round the
    other way; the card's, like numpy's, rounds correctly); the plain
    VJP's dproj_i (g_std = 1), whose branches differ by a factor of 2 or
    0, within rtol 1e-5, on all three branches."""
    from tests.test_torch_cuda import _constant_row_reference
    rng = np.random.RandomState(13)
    n, k, f = 96, 24, 8
    pi = (rng.rand(n, f) * 3 - 1.5).astype(np.float32)
    pj = (rng.rand(n, f) * 3 - 1.5).astype(np.float32)
    cnt = 3 + np.arange(n) % (k - 2)
    idx = np.repeat(rng.randint(0, n, (n, 1)), k, axis=1).astype(np.int32)
    mask = np.arange(k)[None, :] < cnt[:, None]
    args = [_t(a) for a in (pi, pj, idx, mask)]
    mean, mn, mx, sd, _ = nbr.nbr_aggregate_plain(*args)
    zero = torch.zeros(n, f)
    d_i = nbr.nbr_aggregate_vjp(*args, mn, mx, zero, zero, zero,
                                torch.ones(n, f))[0].numpy()
    f32 = np.float32
    want_mean, want_sd, want_d = (np.zeros((n, f), np.float32)
                                  for _ in range(3))
    branches = set()
    for r in range(n):
        for c in range(f):
            h = f32(pi[r, c] + pj[idx[r, 0], c])
            s = sq = f32(0)
            for _ in range(int(cnt[r])):
                s = f32(s + h)
                sq = f32(sq + f32(h * h))
            want_mean[r, c] = m = f32(s / f32(cnt[r]))
            var = f32(f32(sq / f32(cnt[r])) - f32(m * m))
            want_sd[r, c] = np.sqrt(f32(max(var, f32(0)) + f32(1e-5)),
                                    dtype=np.float32)
            want_d[r, c], branch = _constant_row_reference(h, int(cnt[r]),
                                                           1e-5)
            branches.add(branch)
    assert branches == {1.0, 0.5, 0.0}
    np.testing.assert_array_equal(mean.numpy(), want_mean)
    assert np.all(np.abs(sd.numpy() - want_sd) <= np.spacing(want_sd))
    np.testing.assert_allclose(d_i, want_d, rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", ["dense", "edge"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_wrappers_take_the_plain_versions_on_the_cpu(kind, dtype):
    """`nbr_aggregate_bwd` and `pna_edge_bwd` on CPU tensors return their
    plain versions' gradients bit for bit, through the Functions too,
    count no launch and build nothing."""
    tk.reset_launch_counts()
    if kind == "dense":
        arrays = tie_rich_neighbor_case(8, n=30, k=8, f=5, bf16_exact=True)
    else:
        arrays = tie_rich_edge_case(8, n=30, f=5, bf16_exact=True)
    pi, pj = (_t(a).to(dtype) for a in arrays[:2])
    tables = [_t(a) for a in arrays[2:]]
    rng = np.random.RandomState(9)
    gs = [_t(rng.randn(30, 5).astype(np.float32)).to(dtype)
          for _ in range(4)]
    if kind == "dense":
        out = nbr.nbr_aggregate(pi, pj, *tables)
        mn, mx = out[1], out[2]
        got = nbr.nbr_aggregate_bwd(pi, pj, *tables, mn, mx, *gs)
        want = nbr.nbr_aggregate_vjp(pi, pj, *tables, mn, mx, *gs)
        fn_outs = lambda a, b: nbr.nbr_aggregate(a, b, *tables)[:4]
    else:
        acc = fused_mp.pna_edge_accumulators(pi, pj, *tables, 30)
        got = fused_mp.pna_edge_bwd(pi, pj, *tables, 30, acc[3], acc[4],
                                    *gs)
        want = fused_mp.pna_edge_vjp(pi, pj, *tables, 30, acc[3], acc[4],
                                     *gs)

        def fn_outs(a, b):
            acc = fused_mp.pna_edge_accumulators(a, b, *tables, 30)
            return acc[0], acc[1], acc[3], acc[4]
    a, b = pi.clone().requires_grad_(True), pj.clone().requires_grad_(True)
    via_fn = torch.autograd.grad(
        sum((o * g).sum() for o, g in zip(fn_outs(a, b), gs)), (a, b))
    for g, w, v in zip(got, want, via_fn):
        assert g.dtype == dtype
        assert torch.equal(g, w) and torch.equal(g, v)
    assert all(c == 0 for c in tk.launch_counts().values())
    assert not _build._libs
