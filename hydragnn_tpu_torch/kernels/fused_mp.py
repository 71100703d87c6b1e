"""Fused gather -> edge-add -> PNA accumulators over an edge list — the
port of hydragnn_tpu/kernels/fused_mp_pallas.py::fused_pna_edge_aggregate.

`pna_edge_accumulators` launches the CUDA kernel
`csrc/pna_edge_aggregate.cu` for tensors on the card and runs
`pna_edge_accumulators_plain` (the unfused ops/segment.py formulation) for
tensors on the CPU; a CUDA tensor the kernel does not take raises. As on
the TPU, the kernel returns the raw accumulators (s, sq, cnt, mn, mx) and
the mean/std epilogue is the shared `ops.segment.pna_stats_epilogue`
(`pna_edge_aggregate`).

`edge_layout` lays the edges out for the kernel the way `_masked_ids` did
for the TPU: masked edges, and edges whose receiver or sender lies outside
[0, N), are dropped; the rest are stable-sorted by receiver into a CSR
view. The layout depends only on the batch's edges, so a forward computes
it once and hands it to every layer (None on the CPU). On the H100 the kernel is bound by
device-memory bytes (proj_i once, one proj_j row per kept edge, the
outputs) and needs no atomics.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.segment import pna_accumulators, pna_stats_epilogue
from . import _build
from .segment import segment_sum_plain, vec_width

launches = 0


def _kept_edges(senders, receivers, edge_mask, num_nodes):
    return (edge_mask & (receivers >= 0) & (receivers < num_nodes)
            & (senders >= 0) & (senders < num_nodes))


def pna_edge_accumulators_plain(proj_i, proj_j, senders, receivers,
                                edge_mask, num_nodes):
    """(s, sq, cnt [N, 1], mn, mx) of h_e = proj_i[recv] + proj_j[send]
    over the kept edges."""
    keep = _kept_edges(senders, receivers, edge_mask, num_nodes)
    zero = torch.zeros_like(senders)
    send = torch.where(keep, senders, zero).long()
    recv = torch.where(keep, receivers, zero).long()
    data = proj_i[recv] + proj_j[send]
    return pna_accumulators(data, recv, num_nodes, keep,
                            sum_fn=segment_sum_plain)


def _lib():
    fn = _build.load("pna_edge_aggregate").hg_pna_edge_aggregate_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
    return fn


def edge_layout(senders, receivers, edge_mask, num_nodes):
    """(row_ptr [N + 1] int32, senders in receiver order int32): the CSR
    view of the kept edges that the CUDA kernel walks; None for edges on
    the CPU, where the plain version needs no layout."""
    if senders.device.type == "cpu":
        return None
    n = int(num_nodes)
    keep = _kept_edges(senders, receivers, edge_mask, n)
    keys = torch.where(keep, receivers, torch.full_like(receivers, n))
    order = torch.argsort(keys, stable=True)
    # row r spans [row_ptr[r], row_ptr[r + 1]) of the sorted edges; dropped
    # edges (key n) lie past row_ptr[n]
    bounds = torch.arange(n + 1, dtype=keys.dtype, device=keys.device)
    row_ptr = torch.searchsorted(keys[order], bounds, out_int32=True)
    return row_ptr, senders[order].contiguous()


def pna_edge_accumulators(proj_i, proj_j, senders, receivers, edge_mask,
                          num_nodes, layout=None):
    """(s, sq, cnt [N, 1], mn, mx) in float32 over the kept in-edges of
    each node; mn/mx are 0 on a node without one. `layout` is
    `edge_layout` of these edges, computed here when not given."""
    global launches
    if proj_i.device.type == "cpu":
        return pna_edge_accumulators_plain(proj_i, proj_j, senders,
                                           receivers, edge_mask, num_nodes)
    if proj_i.device.type != "cuda":
        raise ValueError(f"pna_edge_aggregate: unsupported device "
                         f"{proj_i.device}")
    n = int(num_nodes)
    if proj_i.dtype != torch.float32 or proj_j.dtype != torch.float32:
        raise TypeError("pna_edge_aggregate kernel takes float32 "
                        f"projections, got {proj_i.dtype}/{proj_j.dtype}")
    if proj_i.dim() != 2 or proj_i.shape[0] != n \
            or proj_j.shape != proj_i.shape:
        raise ValueError(f"pna_edge_aggregate: proj_i {tuple(proj_i.shape)} "
                         f"and proj_j {tuple(proj_j.shape)} must be [{n}, F]")
    e = senders.shape[0]
    if senders.shape != (e,) or receivers.shape != (e,) \
            or edge_mask.shape != (e,):
        raise ValueError("pna_edge_aggregate: senders, receivers and "
                         "edge_mask must be [E]")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32 \
            or edge_mask.dtype != torch.bool:
        raise TypeError("pna_edge_aggregate: senders/receivers must be "
                        "int32 and edge_mask bool")
    tensors = (proj_i, proj_j, senders, receivers, edge_mask)
    if any(t.device != proj_i.device for t in tensors):
        raise ValueError("pna_edge_aggregate: all inputs must be on one "
                         "device")
    if not (proj_i.is_contiguous() and proj_j.is_contiguous()):
        raise ValueError("pna_edge_aggregate: projections must be "
                         "contiguous")
    f = proj_i.shape[1]
    dev = proj_i.device
    row_ptr, send_sorted = (edge_layout(senders, receivers, edge_mask, n)
                            if layout is None else layout)
    if row_ptr.shape != (n + 1,) or send_sorted.shape != (e,) \
            or row_ptr.device != dev or send_sorted.device != dev:
        raise ValueError("pna_edge_aggregate: layout does not match the "
                         "edges")
    s = torch.empty((n, f), dtype=torch.float32, device=dev)
    sq = torch.empty_like(s)
    mn = torch.empty_like(s)
    mx = torch.empty_like(s)
    cnt = torch.empty((n, 1), dtype=torch.float32, device=dev)
    vec = vec_width(f, proj_i, proj_j, s)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(proj_i.data_ptr(), proj_j.data_ptr(), send_sorted.data_ptr(),
                 row_ptr.data_ptr(), n, f, vec, s.data_ptr(), sq.data_ptr(),
                 cnt.data_ptr(), mn.data_ptr(), mx.data_ptr(), stream)
    _build.check_launch(err, "pna_edge_aggregate")
    launches += 1
    return s, sq, cnt, mn, mx


def pna_edge_aggregate(proj_i, proj_j, senders, receivers, edge_mask,
                       num_nodes, eps=1e-5, layout=None):
    """(mean, min, max, std, degree) of proj_i[recv] + proj_j[send] over
    the kept in-edges of each node."""
    return pna_stats_epilogue(
        *pna_edge_accumulators(proj_i, proj_j, senders, receivers,
                               edge_mask, num_nodes, layout), eps)
