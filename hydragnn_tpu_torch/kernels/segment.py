"""Segment sum of 2-D float32 data — the port of
hydragnn_tpu/kernels/segment_pallas.py::segment_sum_pallas.

`segment_sum` launches the CUDA kernel `csrc/segment_sum.cu` for tensors
on the card and runs `segment_sum_plain`, the plain PyTorch version, for
tensors on the CPU. There is no fallback between the two: a CUDA tensor
the kernel does not take raises.

On the H100 the kernel is bound by device-memory bytes (each data row read
once, each output row written once). It walks a CSR view of the rows
sorted by id, `(row_ptr, perm)`: a caller that already holds one passes it
as `layout` (one launch; the EF path reuses its filter layouts), sorted
ids (the pooling case) cost a row-pointer pass and the sum (two
launches), and other ids are argsorted first. Each segment is summed in
chunks of `chunk_rows(F)` rows counted from its own start, a block per
chunk, combined in a fixed order without atomic float adds: the same
result on every run and wherever the segment sits in the batch (the order
depends on F only, not on alignment or the batch). Ids outside [0,
num_segments) add nothing.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import COUNTS_LOCK, _build

# launches of the CUDA kernel in this process (reset by
# kernels.reset_launch_counts)
launches = 0


def segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """out[n] = sum of data[e] over e with segment_ids[e] == n, accumulated
    in float32 and cast back to the data dtype; out-of-range ids add
    nothing. On the CPU the sum runs in row order, so a segment's result
    depends only on its own rows (`index_put_(accumulate=True)` does not
    promise that on the CPU)."""
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    ids = torch.where(valid, ids, torch.zeros_like(ids))
    d = data.float()
    ids = ids.view((-1,) + (1,) * (d.dim() - 1))
    d = torch.where(valid.view(ids.shape), d, torch.zeros_like(d))
    out = torch.zeros((num_segments,) + tuple(d.shape[1:]), dtype=torch.float32,
                      device=d.device)
    out.scatter_add_(0, ids.expand_as(d), d)
    return out.to(data.dtype)


def _lib():
    lib = _build.load("segment_sum")
    fn = lib.hg_segment_sum_f32
    if fn.argtypes is None:
        ptr, num = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr, ptr, num, ptr, num, ptr] + [num] * 5
                       + [ptr] * 4)
        fn.restype = ctypes.c_int
        rp = lib.hg_segment_row_ptr
        rp.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2)
        rp.restype = ctypes.c_int
    return lib


def vec_width(f: int, *tensors: torch.Tensor) -> int:
    """4 (loads of 4 elements: 16 bytes of float32, 8 of bf16) when F % 4
    == 0 and every row pointer is aligned to 4 elements, else 1."""
    if f % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                          for t in tensors):
        return 4
    return 1


# rows each lane of a block loads together: kRows of csrc/segment_sum.cu
ROWS_PER_LANE = 2


def lanes(f: int) -> int:
    """Row lanes of a kernel block for F features (each thread holds 4):
    min(32, the largest power of two with lanes * ceil(F / 4) <= 1024
    threads)."""
    groups = -(-f // 4)
    n = 1
    while n < 32 and n * 2 * groups <= 1024:
        n *= 2
    return n


def chunk_rows(f: int) -> int:
    """Rows per chunk C for F features: ROWS_PER_LANE rows of each lane.
    It depends on F only, so a segment's sum order does too."""
    return ROWS_PER_LANE * lanes(f)


def workspace_rows(e: int, f: int) -> int:
    """Workspace rows of one launch over E rows: ceil(E / C), one per
    window of C sorted positions, each of which starts at most one chunk
    beyond a segment's first (the kernel's grid is N + this many blocks,
    an upper bound known without reading the ids)."""
    return -(-e // chunk_rows(f))


def sorted_row_ptr(sorted_ids: torch.Tensor, n: int) -> torch.Tensor:
    """row_ptr [n + 1] int32 of nondecreasing ids: row_ptr[k] is the first
    position whose id is >= k, so segment k spans [row_ptr[k],
    row_ptr[k + 1]) and ids outside [0, n) lie outside every segment.
    torch.searchsorted on the CPU; on the card the boundary pass of
    csrc/segment_sum.cu (one launch, no search)."""
    ids = sorted_ids.contiguous()
    if ids.device.type == "cpu":
        bounds = torch.arange(n + 1, dtype=ids.dtype)
        return torch.searchsorted(ids, bounds, out_int32=True)
    row_ptr = torch.empty(n + 1, dtype=torch.int32, device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = _lib().hg_segment_row_ptr(ids.data_ptr(), ids.dtype == torch.int64,
                                    ids.shape[0], n, row_ptr.data_ptr(),
                                    stream)
    _build.check_launch(err, "segment_sum row_ptr")
    return row_ptr


# int32 tickets of the chunked sum per (device, stream), 0 between
# launches (each launch leaves them 0). Launches on one stream run in
# order, so launches that may overlap in time never share tickets.
_tickets = {}
_tickets_lock = threading.Lock()
_MIN_TICKETS = 1 << 16


def _tickets_for(device, stream, n):
    """The tickets of launches on `stream`. While the stream is being
    captured into a CUDA graph, a missing or short buffer is made for
    that graph alone (its zeroing is captured with it) and not kept: a
    captured buffer holds nothing until the graph runs. A graph captured
    with a kept buffer uses that stream's tickets when it is replayed."""
    key = (device, stream)
    with _tickets_lock:
        t = _tickets.get(key)
        if t is None or t.shape[0] < n:
            t = torch.zeros(max(n, _MIN_TICKETS), dtype=torch.int32,
                            device=device)
            if not torch.cuda.is_current_stream_capturing():
                _tickets[key] = t
    return t


def segment_layout(segment_ids: torch.Tensor, num_segments: int,
                   keep=None):
    """(row_ptr [num_segments + 1] int32, perm [E] int32): the CSR view of
    the rows whose id lies in [0, num_segments) (and, given `keep` [E]
    bool, is kept), stable-sorted by id; the other rows lie past
    row_ptr[num_segments]. The `layout` a segment sum over these ids
    takes; a caller whose ids serve several sums builds it once. On any
    device."""
    n = int(num_segments)
    valid = (segment_ids >= 0) & (segment_ids < n)
    if keep is not None:
        valid = valid & keep
    keys = torch.where(valid, segment_ids, torch.full_like(segment_ids, n))
    order = torch.argsort(keys, stable=True)
    bounds = torch.arange(n + 1, dtype=keys.dtype, device=keys.device)
    row_ptr = torch.searchsorted(keys[order], bounds, out_int32=True)
    return row_ptr, order.to(torch.int32)


def layout_rows(layout, e: int) -> torch.Tensor:
    """[e] bool: the data rows a CSR `layout = (row_ptr, perm)` sums,
    perm[row_ptr[0]:row_ptr[N]] (no host sync)."""
    row_ptr, perm = layout
    p = torch.arange(e, device=perm.device)
    kept = (p >= row_ptr[0]) & (p < row_ptr[-1])
    return torch.zeros(e, dtype=torch.bool, device=perm.device).scatter_(
        0, perm.long(), kept)


def segment_sum_grad(g: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int, layout=None) -> torch.Tensor:
    """The segment sum's VJP: row e of the result is g[segment_ids[e]],
    0 where the id lies outside [0, num_segments) and, given the forward's
    `layout`, on the rows it leaves out, which added nothing there. The
    gather is `gather_rows`, whose own gradient (a second derivative:
    forces under create_graph) is this segment sum again, summed in a
    fixed order; index_select's is an atomic index_add, whose order
    changes from run to run on the card."""
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    if layout is not None:
        valid = valid & layout_rows(layout, ids.shape[0])
    rows = gather_rows(g, torch.where(valid, segment_ids,
                                      torch.zeros_like(segment_ids)), layout)
    return torch.where(valid.view((-1,) + (1,) * (g.dim() - 1)), rows,
                       torch.zeros_like(rows))


class _SegmentSum(torch.autograd.Function):
    """The segment sum with the JAX VJP as its backward; the forward is
    the kernel for CUDA tensors and the plain version for CPU ones."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, indices_are_sorted,
                layout=None):
        ctx.save_for_backward(segment_ids, *(layout or ()))
        ctx.num_segments = num_segments
        if data.device.type == "cpu":
            return segment_sum_plain(data, segment_ids, num_segments)
        return _launch(data, segment_ids, num_segments, indices_are_sorted,
                       layout)

    @staticmethod
    def backward(ctx, g):
        segment_ids, *layout = ctx.saved_tensors
        return (segment_sum_grad(g, segment_ids, ctx.num_segments,
                                 layout or None), None, None, None, None)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, indices_are_sorted: bool = False,
                layout=None) -> torch.Tensor:
    """Drop-in for the segment sum of [E, F] data into [num_segments, F].
    `indices_are_sorted` promises nondecreasing ids (the pooling case) and
    skips the sort. `layout = (row_ptr [num_segments + 1] int32, perm [E]
    int32/int64)` is a CSR view of the ids the caller already holds
    (`kernels.fused_mp.segment_layouts`): segment n sums the data rows
    perm[row_ptr[n]:row_ptr[n + 1]]. The kernel then sorts nothing; rows
    the layout leaves out (the filter layouts drop masked edges) add
    nothing (and get no gradient), so pass it only where those rows are
    zero or land in rows nobody reads. The CPU path takes the plain
    version and ignores it."""
    if data.device.type == "cpu":
        return segment_sum_plain(data, segment_ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {data.device}")
    if data.dtype != torch.float32:
        raise TypeError(f"segment_sum kernel takes float32, got {data.dtype}")
    if data.dim() != 2 or segment_ids.dim() != 1 \
            or segment_ids.shape[0] != data.shape[0]:
        raise ValueError(f"segment_sum: data {tuple(data.shape)} and ids "
                         f"{tuple(segment_ids.shape)} must be [E, F] and [E]")
    if segment_ids.device != data.device \
            or segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError("segment_sum: ids must be an int32/int64 tensor on "
                        "the data's device")
    if not data.is_contiguous():
        raise ValueError("segment_sum: data must be contiguous")
    e, f = data.shape
    n = int(num_segments)
    if e >= 2 ** 31:
        raise ValueError("segment_sum: more than 2^31 rows")
    if f > 4096:
        raise ValueError(f"segment_sum: F={f} exceeds the kernel's 4096 "
                         "features (1024 threads of 4)")
    if layout is not None:
        row_ptr, perm = layout
        if row_ptr.shape != (n + 1,) or row_ptr.dtype != torch.int32 \
                or perm.shape != (e,) \
                or perm.dtype not in (torch.int32, torch.int64) \
                or row_ptr.device != data.device \
                or perm.device != data.device \
                or not (row_ptr.is_contiguous() and perm.is_contiguous()):
            raise ValueError("segment_sum: layout must be (row_ptr [N + 1] "
                             "int32, perm [E] int32/int64), contiguous, on "
                             "the data's device")
    return _SegmentSum.apply(data, segment_ids, n, indices_are_sorted,
                             layout)


def _launch(data, segment_ids, n, indices_are_sorted, layout):
    """One call of csrc/segment_sum.cu on checked inputs: the row-pointer
    pass unless a layout is given, then the chunked sum, which also reads
    the sorted ids when there are any."""
    global launches
    e, f = data.shape
    perm = keys = None
    if layout is not None:
        row_ptr, perm = layout
    elif indices_are_sorted:
        keys = segment_ids.contiguous()
    else:
        valid = (segment_ids >= 0) & (segment_ids < n)
        keys = torch.where(valid, segment_ids,
                           torch.full_like(segment_ids, n))
        perm = torch.argsort(keys, stable=True)
        keys = keys[perm]
    if keys is not None:
        row_ptr = sorted_row_ptr(keys, n)
    dev = data.device
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    ws = torch.empty((max(workspace_rows(e, f), 1), f), dtype=torch.float32,
                     device=dev)
    vec = vec_width(f, data, out, ws)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def is_64(t):
        return t is not None and t.dtype == torch.int64
    err = _lib().hg_segment_sum_f32(
        data.data_ptr(), ptr(perm), is_64(perm), ptr(keys), is_64(keys),
        row_ptr.data_ptr(), e, n, f, vec, lanes(f), out.data_ptr(),
        ws.data_ptr(), _tickets_for(dev, stream, n).data_ptr(), stream)
    _build.check_launch(err, "segment_sum")
    with COUNTS_LOCK:
        launches += 1
    return out


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ids, layout=None):
        ctx.save_for_backward(ids)
        ctx.num_rows = x.shape[0]
        ctx.layout = layout
        return x.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        # bf16 gradients sum in float32 and are stored back once (the
        # kernel takes float32; ops/segment.py `_accum_f32`)
        d = segment_sum(g.float().contiguous(), ids, ctx.num_rows,
                        layout=ctx.layout)
        return d.to(g.dtype), None, None


def gather_rows(x: torch.Tensor, ids: torch.Tensor,
                layout=None) -> torch.Tensor:
    """x[ids] for [N, F] x and [E] ids in [0, N); its gradient is the
    segment sum of the incoming [E, F] gradient by `ids`, over `layout`
    (a CSR view of `ids`, see `segment_sum`) when one is given. An
    [N, ...] x (a vector channel [N, 3, F]) is gathered as [N, prod(...)]
    rows, a 1-D x as [N, 1]."""
    if x.dim() == 1:
        return _GatherRows.apply(x[:, None], ids, layout)[:, 0]
    if x.dim() > 2:
        rows = _GatherRows.apply(x.reshape(x.shape[0], -1), ids, layout)
        return rows.view(tuple(ids.shape) + tuple(x.shape[1:]))
    return _GatherRows.apply(x, ids, layout)
