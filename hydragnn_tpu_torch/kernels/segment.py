"""Segment sum of 2-D float32 data — the port of
hydragnn_tpu/kernels/segment_pallas.py::segment_sum_pallas.

`segment_sum` launches the CUDA kernel `csrc/segment_sum.cu` for tensors
on the card and runs `segment_sum_plain`, the plain PyTorch version, for
tensors on the CPU. There is no fallback between the two: a CUDA tensor
the kernel does not take raises.

On the H100 the kernel is bound by device-memory bytes (each data row read
once, each output row written once). One block sums one segment over the
rows sorted by id (no atomics: the same result on every run), so sorted
ids (the pooling case) cost one launch. Ids outside [0, num_segments) add
nothing.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

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
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def vec_width(f: int, *tensors: torch.Tensor) -> int:
    """4 (16-byte loads) when F % 4 == 0 and every row pointer is 16-byte
    aligned, else 1."""
    if f % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors):
        return 4
    return 1


def segment_sum_grad(g: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """The segment sum's VJP: row e of the result is g[segment_ids[e]],
    0 where the id lies outside [0, num_segments)."""
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    rows = g.index_select(0, torch.where(valid, ids, torch.zeros_like(ids)))
    return torch.where(valid.view((-1,) + (1,) * (g.dim() - 1)), rows,
                       torch.zeros_like(rows))


class _SegmentSum(torch.autograd.Function):
    """The segment sum with the JAX VJP as its backward; the forward is
    the kernel for CUDA tensors and the plain version for CPU ones."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, indices_are_sorted):
        ctx.save_for_backward(segment_ids)
        ctx.num_segments = num_segments
        if data.device.type == "cpu":
            return segment_sum_plain(data, segment_ids, num_segments)
        return _launch(data, segment_ids, num_segments, indices_are_sorted)

    @staticmethod
    def backward(ctx, g):
        (segment_ids,) = ctx.saved_tensors
        return (segment_sum_grad(g, segment_ids, ctx.num_segments), None,
                None, None)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                indices_are_sorted: bool = False) -> torch.Tensor:
    """Drop-in for the segment sum of [E, F] data into [num_segments, F].
    `indices_are_sorted` promises nondecreasing ids (the pooling case) and
    skips the sort."""
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
    if e >= 2 ** 31:
        raise ValueError("segment_sum: more than 2^31 rows")
    if f // vec_width(f) > 1024:
        raise ValueError(f"segment_sum: F={f} exceeds the kernel's 1024 "
                         "feature groups per block")
    return _SegmentSum.apply(data, segment_ids, int(num_segments),
                             indices_are_sorted)


def _launch(data, segment_ids, n, indices_are_sorted):
    """One launch of csrc/segment_sum.cu on checked inputs."""
    global launches
    e, f = data.shape
    if indices_are_sorted:
        perm = None
        # clamping keeps the order and maps every out-of-range id outside
        # [0, n), so the int32 ids the kernel searches stay sorted
        keys = segment_ids if segment_ids.dtype == torch.int32 else \
            torch.clamp(segment_ids, -1, n).to(torch.int32)
    else:
        valid = (segment_ids >= 0) & (segment_ids < n)
        keys = torch.where(valid, segment_ids,
                           torch.full_like(segment_ids, n))
        perm = torch.argsort(keys, stable=True)
        keys = keys[perm].to(torch.int32)
    keys = keys.contiguous()
    out = torch.empty((n, f), dtype=torch.float32, device=data.device)
    vec = vec_width(f, data, out)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    err = _lib()(data.data_ptr(), None if perm is None else perm.data_ptr(),
                 keys.data_ptr(), e, out.data_ptr(), n, f, vec, stream)
    _build.check_launch(err, "segment_sum")
    launches += 1
    return out


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, ids)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return segment_sum(g.contiguous(), ids, ctx.num_rows), None


def gather_rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[ids] for [N, F] x and [E] ids in [0, N); its gradient is the
    segment sum of the incoming [E, F] gradient by `ids`."""
    return _GatherRows.apply(x, ids)
