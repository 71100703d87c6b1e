"""The port's kernel wrappers (hydragnn_tpu_torch/kernels) against the JAX
package's Pallas kernels, run in interpret mode as tests/test_kernels.py
runs them. On the CPU each wrapper takes its plain PyTorch version, so
these tests pin what the CUDA kernels are held to on the card.

Bounds: gathers, min, max and count are exact. Sums, and the mean/std
derived from them, use tests/test_kernels.py's rtol 2e-5 / atol 2e-5: the
plain version and the Pallas kernel add in different orders.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.kernels.fused_mp_pallas import _fused_pna_accums
from hydragnn_tpu.kernels.nbr_pallas import fused_neighbor_aggregate
from hydragnn_tpu.kernels.segment_pallas import segment_sum_pallas
from hydragnn_tpu_torch import kernels as tk
from hydragnn_tpu_torch.kernels import fused_mp, nbr, segment

SUM_TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("e,f,n", [(700, 24, 130), (64, 8, 5),
                                   (2048, 200, 129)])
def test_segment_sum_matches_pallas(e, f, n):
    rng = np.random.RandomState(e)
    data = rng.randn(e, f).astype(np.float32)
    ids = rng.randint(0, n, e).astype(np.int32)
    ids[:7] = n + 3          # ids out of range add nothing
    ids[7:9] = -2
    data[ids == 1] = 0.0     # (a possibly) empty segment stays zero
    ids[ids == 1] = 2
    want = np.asarray(segment_sum_pallas(jnp.asarray(data), jnp.asarray(ids),
                                         n, True))
    got = segment.segment_sum(_t(data), _t(ids), n).numpy()
    np.testing.assert_allclose(got, want, **SUM_TOL)
    assert not got[1].any()


def test_segment_sum_sorted_ids_and_integer_data_exact():
    """Pooling ids are sorted; integer-valued data sums exactly in any
    order, so the plain version equals the Pallas kernel bitwise."""
    rng = np.random.RandomState(3)
    ids = np.sort(rng.randint(0, 9, 300)).astype(np.int32)
    data = rng.randint(-3, 4, (300, 16)).astype(np.float32)
    want = np.asarray(segment_sum_pallas(jnp.asarray(data), jnp.asarray(ids),
                                         10, True))
    got = segment.segment_sum(_t(data), _t(ids), 10,
                              indices_are_sorted=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[9].any()


def test_segment_sum_plain_is_deterministic_and_row_independent():
    """A segment's sum depends only on its own rows, in row order: the
    CPU engine's batched-vs-single bitwise contract rests on it. Large
    enough that a parallel CPU scatter would show a different order."""
    rng = np.random.RandomState(5)
    e, f, n = 53120, 33, 5120
    data = rng.randn(e, f).astype(np.float32)
    ids = rng.randint(0, n, e).astype(np.int32)
    other = data.copy()
    other[ids >= 10] = rng.randn(int((ids >= 10).sum()), f)
    a = segment.segment_sum(_t(data), _t(ids), n).numpy()
    b = segment.segment_sum(_t(other), _t(ids), n).numpy()
    np.testing.assert_array_equal(
        a, segment.segment_sum(_t(data), _t(ids), n).numpy())
    np.testing.assert_array_equal(a[:10], b[:10])
    ref = np.zeros((10, f), np.float32)
    for row, seg_id in zip(data, ids):
        if seg_id < 10:
            ref[seg_id] += row
    np.testing.assert_array_equal(a[:10], ref)


def _nbr_inputs(seed, n=136, k=9, f=32):
    rng = np.random.RandomState(seed)
    pi = rng.randn(n, f).astype(np.float32)
    pj = rng.randn(n, f).astype(np.float32)
    idx = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.3
    mask[5] = False                # an isolated node: no neighbour slot
    mask[6, 1:] = False            # a node with exactly one neighbour
    mask[6, 0] = True
    return pi, pj, idx, mask


def test_nbr_aggregate_matches_pallas():
    pi, pj, idx, mask = _nbr_inputs(0)
    want = fused_neighbor_aggregate(jnp.asarray(pi), jnp.asarray(pj),
                                    jnp.asarray(idx), jnp.asarray(mask),
                                    64, True)
    got = nbr.nbr_aggregate(_t(pi), _t(pj), _t(idx), _t(mask))
    for name, g, w in zip(("mean", "min", "max", "std", "deg"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("min", "max", "deg"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **SUM_TOL)
    mean, mn, mx, sd, deg = (t.numpy() for t in got)
    assert deg[5] == 0 and not mn[5].any() and not mx[5].any()
    assert deg[6] == 1 and np.array_equal(mn[6], mx[6])


def test_nbr_aggregate_out_of_range_slot_counts_as_masked():
    pi, pj, idx, mask = _nbr_inputs(1, n=20, k=4, f=8)
    mask[:] = True
    idx2 = idx.copy()
    idx2[3, 2] = 25
    mask2 = mask.copy()
    mask2[3, 2] = False
    a = nbr.nbr_aggregate(_t(pi), _t(pj), _t(idx2), _t(mask))
    b = nbr.nbr_aggregate(_t(pi), _t(pj), _t(idx2 % 20), _t(mask2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _edge_inputs(seed, n=40, e=300, f=24):
    rng = np.random.RandomState(seed)
    pi = rng.randn(n, f).astype(np.float32)
    pj = rng.randn(n, f).astype(np.float32)
    send = rng.randint(0, n, e).astype(np.int32)
    recv = rng.randint(0, n, e).astype(np.int32)
    recv[recv == 7] = 8            # node 7: isolated
    emask = rng.rand(e) > 0.2
    emask[-20:] = False            # padding edges
    recv[-20:] = n - 1
    send[-20:] = n - 1
    recv[:3] = n + 5               # receivers out of range: dropped
    return pi, pj, send, recv, emask


def test_pna_edge_accumulators_match_pallas():
    pi, pj, send, recv, emask = _edge_inputs(0)
    n = pi.shape[0]
    want = _fused_pna_accums(jnp.asarray(pi), jnp.asarray(pj),
                             jnp.asarray(send), jnp.asarray(recv),
                             jnp.asarray(emask), n, True)
    got = fused_mp.pna_edge_accumulators(_t(pi), _t(pj), _t(send), _t(recv),
                                         _t(emask), n)
    for name, g, w in zip(("s", "sq", "cnt", "min", "max"), got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("cnt", "min", "max"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **SUM_TOL)
    s, sq, cnt, mn, mx = (t.numpy() for t in got)
    assert cnt[7, 0] == 0 and not mn[7].any() and not mx[7].any()


def test_pna_edge_aggregate_epilogue_matches_pallas():
    from hydragnn_tpu.kernels.fused_mp_pallas import fused_pna_edge_aggregate
    pi, pj, send, recv, emask = _edge_inputs(2, n=30, e=200, f=16)
    n = pi.shape[0]
    want = fused_pna_edge_aggregate(jnp.asarray(pi), jnp.asarray(pj),
                                    jnp.asarray(send), jnp.asarray(recv),
                                    jnp.asarray(emask), n, 1e-5, True)
    got = fused_mp.pna_edge_aggregate(_t(pi), _t(pj), _t(send), _t(recv),
                                      _t(emask), n)
    for name, g, w in zip(("mean", "min", "max", "std", "deg"), got, want):
        g, w = g.numpy(), np.asarray(w)
        if name in ("min", "max", "deg"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **SUM_TOL)


def test_cpu_tensors_take_the_plain_version_without_launching():
    tk.reset_launch_counts()
    pi, pj, idx, mask = _nbr_inputs(4, n=12, k=3, f=8)
    nbr.nbr_aggregate(_t(pi), _t(pj), _t(idx), _t(mask))
    pi, pj, send, recv, emask = _edge_inputs(4, n=12, e=40, f=8)
    fused_mp.pna_edge_accumulators(_t(pi), _t(pj), _t(send), _t(recv),
                                   _t(emask), 12)
    # the plain version needs no CSR layout: none is built for CPU edges
    assert fused_mp.edge_layout(_t(send), _t(recv), _t(emask), 12) is None
    segment.segment_sum(_t(pi), _t(np.arange(12, dtype=np.int32) % 3), 3)
    assert tk.launch_counts() == {"segment_sum": 0, "nbr_aggregate": 0,
                                  "pna_edge_aggregate": 0}
    from hydragnn_tpu_torch.kernels import _build
    assert not _build._libs  # nothing was built or loaded


def test_kernel_modules_import_without_nvcc():
    code = ("import os, sys; os.environ['PATH'] = ''; "
            "os.environ.pop('CUDA_HOME', None); "
            "import hydragnn_tpu_torch.kernels.segment, "
            "hydragnn_tpu_torch.kernels.nbr, "
            "hydragnn_tpu_torch.kernels.fused_mp as fm; "
            "from hydragnn_tpu_torch.kernels import _build; "
            "assert not _build._libs; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
