"""The port's kernel wrappers (hydragnn_tpu_torch/kernels) against the JAX
package's Pallas kernels, run in interpret mode as tests/test_kernels.py
runs them. On the CPU each wrapper takes its plain PyTorch version, so
these tests pin what the CUDA kernels are held to on the card.

Bounds: gathers, min, max and count are exact. Sums, and the mean/std
derived from them, use tests/test_kernels.py's rtol 2e-5 / atol 2e-5: the
plain version and the Pallas kernel add in different orders. The
filter-scatter is held as tests/test_kernels.py holds the Pallas kernel
to its unfused formulation: bitwise on integer-valued data, rtol/atol
1e-6 on random float32 data.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydragnn_tpu.kernels.fused_mp_pallas import (_fused_pna_accums,
                                                  fused_filter_scatter)
from hydragnn_tpu.kernels.nbr_pallas import fused_neighbor_aggregate
from hydragnn_tpu.kernels.segment_pallas import segment_sum_pallas
from hydragnn_tpu_torch import kernels as tk
from hydragnn_tpu_torch.kernels import fused_mp, nbr, segment

# Eager torch on small tensors: one intra-op thread, so that the test
# workers sharing the machine's cores do not oversubscribe them (8
# threads per worker made these tests 30x slower under pytest-xdist).
torch.set_num_threads(1)

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
    h, w, fsend, frecv, fmask = _filter_inputs(4, n=12, e=40, f=8)
    fused_mp.filter_scatter(_t(h), _t(w), _t(fsend), _t(frecv), _t(fmask),
                            12)
    assert fused_mp.filter_layouts(_t(fsend), _t(frecv), _t(fmask),
                                   12) is None
    assert tk.launch_counts() == {"segment_sum": 0, "nbr_aggregate": 0,
                                  "pna_edge_aggregate": 0,
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
    from hydragnn_tpu_torch.kernels import _build
    assert not _build._libs  # nothing was built or loaded


def _filter_inputs(seed, n=150, e=700, f=16, integer=False,
                   out_of_range=True):
    """SchNet filter-scatter inputs: masked edges, an isolated node and,
    with `out_of_range`, receivers and senders outside [0, n), whose
    edges add nothing."""
    rng = np.random.RandomState(seed)
    if integer:
        h = rng.randint(-2, 3, (n, f)).astype(np.float32)
        w = rng.randint(-2, 3, (e, f)).astype(np.float32)
    else:
        h = rng.randn(n, f).astype(np.float32)
        w = rng.randn(e, f).astype(np.float32)
    send = rng.randint(0, n, e).astype(np.int32)
    recv = rng.randint(0, n, e).astype(np.int32)
    recv[recv == 11 % n] = 12 % n  # node 11: no in-edge
    mask = rng.rand(e) > 0.25
    if out_of_range:
        recv[:5] = n + 4
        recv[5:7] = -3
        send[7:9] = n + 2
    return h, w, send, recv, mask


@pytest.mark.parametrize("integer", [True, False])
def test_filter_scatter_matches_pallas(integer):
    """n = 150, e = 700, f = 16: neither a multiple of the TPU kernel's
    tiles nor of a CUDA block."""
    h, w, send, recv, mask = _filter_inputs(0, integer=integer)
    n = h.shape[0]
    want = np.asarray(fused_filter_scatter(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(send), jnp.asarray(recv),
        jnp.asarray(mask), n, True))
    got = fused_mp.filter_scatter(_t(h), _t(w), _t(send), _t(recv), _t(mask),
                                  n).numpy()
    if integer:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[11].any()


def _jax_filter_grads(h, w, send, recv, mask, g):
    n = h.shape[0]

    def loss(a, b):
        out = fused_filter_scatter(a, b, jnp.asarray(send), jnp.asarray(recv),
                                   jnp.asarray(mask), n, True)
        return jnp.sum(out * jnp.asarray(g))
    return [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))]


def test_filter_scatter_grads_match_jax():
    """dh and dw of the plain version (the CPU path) and of the autograd
    Function the card runs (its forward takes the plain version on CPU
    tensors; its backward is the kernel's: dh by the same filter-scatter
    on the transposed edges, dw a gather-multiply) against jax.grad
    through the Pallas kernel's VJP. dw is the same product of the same
    two numbers: exact. dh sums the same products in another order:
    rtol/atol 1e-6. Senders stay in range here: for an out-of-range
    sender the JAX VJP gathers a clamped row that the forward drops."""
    h, w, send, recv, mask = _filter_inputs(1, out_of_range=False)
    recv[:5] = h.shape[0] + 4
    n = h.shape[0]
    g = np.random.RandomState(9).randn(n, h.shape[1]).astype(np.float32)
    want_dh, want_dw = _jax_filter_grads(h, w, send, recv, mask, g)
    idx = (_t(send), _t(recv), _t(mask), n)
    for fn in (fused_mp.filter_scatter,
               lambda a, b, *rest: fused_mp._FilterScatter.apply(
                   a, b, *rest, None, None)):
        th = _t(h).requires_grad_(True)
        tw = _t(w).requires_grad_(True)
        dh, dw = torch.autograd.grad((fn(th, tw, *idx) * _t(g)).sum(),
                                     (th, tw))
        np.testing.assert_array_equal(dw.numpy(), want_dw)
        np.testing.assert_allclose(dh.numpy(), want_dh, rtol=1e-6, atol=1e-6)


def test_filter_scatter_function_differentiates_twice():
    """The Function's backward is made of differentiable ops (itself and
    a gather-multiply), so a force loss can take its gradient again:
    d/dw of <dh, k> matches the plain version's."""
    h, w, send, recv, mask = _filter_inputs(2, n=40, e=200, f=8)
    n = h.shape[0]
    rng = np.random.RandomState(3)
    g, k = (_t(rng.randn(n, 8).astype(np.float32)) for _ in range(2))
    out = []
    for fn in (fused_mp.filter_scatter_plain,
               lambda *a: fused_mp._FilterScatter.apply(*a, None, None)):
        th = _t(h).requires_grad_(True)
        tw = _t(w).requires_grad_(True)
        y = fn(th, tw, _t(send), _t(recv), _t(mask), n)
        (dh,) = torch.autograd.grad((y * g).sum(), th, create_graph=True)
        out.append(torch.autograd.grad((dh * k).sum(), tw)[0])
    torch.testing.assert_close(out[1], out[0], rtol=1e-6, atol=1e-6)


def test_segment_sum_backward_matches_jax():
    """The segment sum's autograd Function (the card's path; CPU tensors
    take the plain forward inside it) returns the JAX VJP g[ids] bitwise
    on rows with ids in range, and 0 on rows whose id is out of range,
    which the forward drops (the JAX VJP's gather clamps such an id and
    returns a row of g there). `gather_rows`' backward is a segment sum,
    within SUM_TOL of the JAX gather's VJP."""
    rng = np.random.RandomState(4)
    e, f, n = 300, 5, 40
    data = rng.randn(e, f).astype(np.float32)
    ids = rng.randint(0, n, e).astype(np.int32)
    ids[:4] = n + 2
    ids[4:6] = -1
    g = rng.randn(n, f).astype(np.float32)
    want = np.asarray(jax.grad(lambda d: jnp.sum(segment_sum_pallas(
        d, jnp.asarray(ids), n, True) * jnp.asarray(g)))(jnp.asarray(data)))
    td = _t(data).requires_grad_(True)
    out = segment._SegmentSum.apply(td, _t(ids), n, False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(
        segment_sum_pallas(jnp.asarray(data), jnp.asarray(ids), n, True)),
        **SUM_TOL)
    (got,) = torch.autograd.grad((out * _t(g)).sum(), td)
    np.testing.assert_array_equal(got.numpy()[6:], want[6:])
    assert not got[:6].any()

    x = rng.randn(n, 3).astype(np.float32)
    gi = rng.randint(0, n, e).astype(np.int32)
    ge = rng.randn(e, 3).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(
        a[jnp.asarray(gi)] * jnp.asarray(ge)))(jnp.asarray(x)))
    tx = _t(x).requires_grad_(True)
    rows = segment.gather_rows(tx, _t(gi))
    assert torch.equal(rows.detach(), _t(x)[_t(gi).long()])
    (got,) = torch.autograd.grad((rows * _t(ge)).sum(), tx)
    np.testing.assert_allclose(got.numpy(), want, **SUM_TOL)


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


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_sorted_row_ptr_matches_numpy(dtype):
    """row_ptr of nondecreasing ids, with ids below 0, empty segments and
    ids past the last segment: numpy's searchsorted, bitwise (the CUDA
    boundary pass is held against this version in tests/test_torch_cuda.py)."""
    rng = np.random.RandomState(7)
    ids = np.sort(np.concatenate([rng.randint(-3, 0, 4),
                                  rng.choice([0, 2, 3, 3, 7, 9], 60),
                                  rng.randint(12, 15, 5)])).astype(dtype)
    for n in (12, 1, 20):
        got = segment.sorted_row_ptr(_t(ids), n)
        want = np.searchsorted(ids, np.arange(n + 1), side="left")
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    empty = segment.sorted_row_ptr(_t(ids[:0]), 4)
    np.testing.assert_array_equal(empty.numpy(), np.zeros(5))


def _claimed_chunks(row_ptr, c):
    """Emulate csrc/segment_sum.cu's grid in numpy: the (segment, chunk)
    each block sums. Blocks 0..N-1 take chunk 0 of their segment; block
    N + j the chunk k >= 1 of the segment holding sorted position j C
    that starts in [j C, (j + 1) C), if any."""
    n, e = len(row_ptr) - 1, int(row_ptr[-1])
    claims = [(s, 0) for s in range(n)]
    for j in range(-(-e // c)):
        q = j * c
        if not row_ptr[0] <= q < row_ptr[n]:
            continue
        s = int(np.searchsorted(row_ptr, q, side="right")) - 1
        k = -(-(q - row_ptr[s]) // c)
        x = row_ptr[s] + k * c
        if k >= 1 and x < row_ptr[s + 1] and x < q + c:
            claims.append((s, k))
    return claims


@pytest.mark.parametrize("f", [1, 3, 13, 200])
def test_chunk_grid_covers_every_chunk_once(f):
    """The host's sizing (lanes, C = ROWS_PER_LANE x lanes, workspace
    rows ceil(E / C), so N + ceil(E / C) blocks) against its formula, and
    the kernel's window rule, emulated in numpy: over segment lengths from
    0 to many chunks, every chunk of every segment is claimed by exactly
    one block."""
    groups = -(-f // 4)
    assert segment.lanes(f) == min(32, 2 ** int(np.log2(1024 // groups)))
    c = segment.chunk_rows(f)
    assert c == segment.ROWS_PER_LANE * segment.lanes(f)
    # the host's R sizes the workspace: it must be the kernel's kRows
    src = (Path(segment.__file__).parent.parent / "csrc"
           / "segment_sum.cu").read_text()
    assert f"constexpr int kRows = {segment.ROWS_PER_LANE};" in src
    rng = np.random.RandomState(f)
    lengths = np.concatenate([[0, 1, c - 1, c, c + 1, 0, 7 * c + 3],
                              rng.randint(0, 3 * c, 40), [40 * c + 9]])
    row_ptr = np.concatenate([[0], np.cumsum(lengths)])
    e, n = int(row_ptr[-1]), len(lengths)
    windows = segment.workspace_rows(e, f)
    assert windows == -(-e // c)
    claims = _claimed_chunks(row_ptr, c)
    want = [(s, k) for s, length in enumerate(lengths)
            for k in range(max(1, -(-int(length) // c)))]
    assert sorted(claims) == want
    assert len(claims) <= n + windows


def test_csr_layout_and_segment_layouts_match_numpy():
    """The CSR edge layout (on the CPU here; the card builds the same)
    against numpy's stable argsort: masked and out-of-range edges are
    dropped past row_ptr[N]; `segment_layouts` hands (row_ptr, order) of
    the receiver- and sender-sorted layouts to the segment sums."""
    h, w, send, recv, mask = _filter_inputs(6, n=30, e=200, f=4)
    n = 30
    keep = mask & (recv >= 0) & (recv < n) & (send >= 0) & (send < n)
    layouts = []
    for a, b in ((send, recv), (recv, send)):
        got = fused_mp.csr_layout(_t(a), _t(b), _t(mask), n)
        keys = np.where(keep, b, n)
        order = np.argsort(keys, kind="stable")
        row_ptr = np.searchsorted(keys[order], np.arange(n + 1))
        for g, want in zip(got, (row_ptr, a[order], order)):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), want)
        assert int(got[0][-1]) == int(keep.sum())
        layouts.append(got)
    by_recv, by_send = fused_mp.segment_layouts(tuple(layouts))
    assert by_recv[0] is layouts[0][0] and by_recv[1] is layouts[0][2]
    assert by_send[0] is layouts[1][0] and by_send[1] is layouts[1][2]
    assert fused_mp.segment_layouts(None) == (None, None)


def test_segment_sum_grad_leaves_out_the_rows_a_layout_drops():
    """The segment sum's VJP given the forward's CSR layout (the kernel
    sums only perm[row_ptr[0]:row_ptr[N]]): g[id] on those rows, 0 on the
    rows the layout leaves out and on ids out of range, against numpy,
    bitwise; without a layout every in-range row gets g[id]."""
    h, w, send, recv, mask = _filter_inputs(8, n=30, e=200, f=4)
    n = 30
    row_ptr, _, order = fused_mp.csr_layout(_t(send), _t(recv), _t(mask), n)
    keep = mask & (recv >= 0) & (recv < n) & (send >= 0) & (send < n)
    in_layout = np.zeros(200, bool)
    in_layout[order.numpy()[:int(row_ptr[-1])]] = True
    np.testing.assert_array_equal(
        segment.layout_rows((row_ptr, order), 200).numpy(), in_layout)
    np.testing.assert_array_equal(in_layout, keep)
    g = np.random.RandomState(9).randn(n, 3).astype(np.float32)
    valid = (recv >= 0) & (recv < n)
    rows = g[np.clip(recv, 0, n - 1)]
    for layout, kept in ((None, valid), ((row_ptr, order), keep)):
        got = segment.segment_sum_grad(_t(g), _t(recv), n, layout)
        np.testing.assert_array_equal(got.numpy(),
                                      np.where(kept[:, None], rows, 0))
