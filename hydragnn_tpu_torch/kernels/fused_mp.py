"""Fused gather -> edge-op -> scatter kernels over an edge list — the port
of hydragnn_tpu/kernels/fused_mp_pallas.py: `fused_pna_edge_aggregate`
(PNA) and `fused_filter_scatter` (SchNet's CFConv).

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

The accumulators run inside `_PnaEdgeAccums`, whose backward is
`pna_edge_bwd`, the JAX VJP (a remat through the unfused accumulators) in
closed form: per kept edge dh = g_s[recv] + 2 h g_sq[recv] plus the
min/max cotangent shared evenly by the tied edges (`edge_grads`), then
dproj_i and dproj_j as the sums of dh over the receivers and the senders.
For tensors on the card it is the CUDA kernel `csrc/pna_backward.cu`, two
launches: by receiver on the forward's receiver-sorted layout, on the
dense kernels' whole-warp geometry (`row_geometry`), writing each kept
edge's dh to its row of an [E, F] buffer, its position in the
sender-sorted layout (`edge_positions`, built once per forward); then by
sender, a streaming in-order sum of those rows. No atomics; for CPU
tensors its plain version `pna_edge_vjp`, in torch ops and segment sums.

`filter_scatter` computes out[n] = sum over the kept edges e into n of
h[send[e]] * w[e]: the CUDA kernel `csrc/filter_scatter.cu` walks the
receiver-sorted layout for tensors on the card (inside `_FilterScatter`,
its autograd Function), `filter_scatter_plain` runs for tensors on the
CPU. The backward is the JAX VJP: dw[e] = g[recv[e]] * h[send[e]] on kept
edges (a per-edge gather-multiply in torch ops), and dh, the same
filter-scatter over the transposed edges (g gathered by receiver, summed
into senders), is the Function called again on the sender-sorted layout.
So the gradient needs no atomics either, and is itself differentiable.
`filter_layouts` builds both layouts once per forward, and
`segment_layouts` hands them to the segment sums over the same edges (the
position gathers' backward and the coordinate update on the EF path), so
those sort nothing.

bf16. Both kernels have a float32 and a bf16 instantiation, picked by the
inputs' dtype (one dtype for both operands; any other dtype raises on the
card). At bf16 the messages (proj_i + proj_j, its square, h * w) round
to bf16 and the sums accumulate in float32 and are stored back in bf16 —
the accumulators' s, sq and cnt as `fused_mp_pallas.py:336-340` casts
them — so the plain versions, which follow `_accum_f32`, compute the same
function. The backwards run in the compute dtype; tie counts and their
segment sums are taken in float32.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..ops.segment import pna_accumulators, pna_stats_epilogue
from . import COUNTS_LOCK, _build
from .nbr import STAGE_SLOTS, row_geometry
from .segment import (gather_rows, segment_layout, segment_sum,
                      segment_sum_plain, vec_width)

launches = 0              # pna_edge_aggregate, either instantiation
bf16_launches = 0         # of which the bf16 instantiation
backward_kernel_launches = 0       # pna_edge_aggregate backward kernel
backward_kernel_bf16_launches = 0  # launches, 2 a call; of which bf16
filter_launches = 0       # filter_scatter, forward calls
filter_bf16_launches = 0  # of which the bf16 instantiation
filter_backward_launches = 0  # filter_scatter, the dh of a backward
filter_backward_bf16_launches = 0  # of which the bf16 instantiation

# the forward kernel's receivers a block on whole-warp rows
# (csrc/slots.cuh) per dtype; 0: flat blocks of 256 threads over the
# (receiver, feature group) pairs. On the H100 (PERF.md §6) whole-warp
# rows read 3-7 % faster than flat at float32, flat 1-2 % faster than
# whole-warp rows at bf16 (N 4,032 and 8,192, F 200)
FORWARD_ROWS = {torch.float32: 2, torch.bfloat16: 0}


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


def _lib(dtype):
    fn = getattr(_build.load("pna_edge_aggregate"),
                 f"hg_pna_edge_aggregate_{_build.DTYPE_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
    return fn


def edge_layout(senders, receivers, edge_mask, num_nodes):
    """`csr_layout` of the edges for the CUDA kernels to walk; None for
    edges on the CPU, where the plain versions need no layout."""
    if senders.device.type == "cpu":
        return None
    return csr_layout(senders, receivers, edge_mask, num_nodes)


def csr_layout(senders, receivers, edge_mask, num_nodes):
    """(row_ptr [N + 1] int32, senders in receiver order int32, edge ids
    in receiver order int32): the CSR view of the kept edges, stable-sorted
    by receiver; dropped edges lie past row_ptr[N]. On any device."""
    n = int(num_nodes)
    row_ptr, order = segment_layout(
        receivers, n, _kept_edges(senders, receivers, edge_mask, n))
    return row_ptr, senders[order].contiguous(), order


def edge_positions(layout, layout_t):
    """[E] int32: for the edge at position r of the receiver-sorted
    `csr_layout` (`layout`), its position in the sender-sorted one
    (`layout_t`) of the same edges, the row of the backward kernel's dh
    buffer it fills; -1 past row_ptr[N] (the dropped edges). None when
    the layouts are (on the CPU). On any device."""
    if layout is None:
        return None
    row_ptr, _, order = layout
    at = torch.arange(order.shape[0], dtype=torch.int32, device=order.device)
    where_t = torch.empty_like(at).index_put_((layout_t[2].long(),), at)
    return torch.where(at < row_ptr[-1], where_t[order.long()], -1)


def pna_edge_vjp(proj_i, proj_j, senders, receivers, edge_mask, num_nodes,
                 mn, mx, g_s, g_sq, g_min, g_max, layout=None, layout_t=None):
    """(dproj_i, dproj_j) of the accumulators (s, sq, cnt, mn, mx) for the
    cotangents g_*, with h_e = proj_i[recv] + proj_j[send] on the kept
    edges: dh_e = g_s[recv] + 2 h_e g_sq[recv] + g_min[recv] [h_e ==
    mn[recv]] / ties + the same for max (tied edges share a node's
    cotangent evenly, as JAX's segment min/max VJPs do); dproj_i and
    dproj_j are the segment sums of dh over the receivers and the senders.
    `layout` / `layout_t` are the receiver- and sender-sorted
    `edge_layout`s of these edges (on the card; built here when not given);
    the tie counts ride the receiver-sorted one too. In bf16 the ties are
    counted and every segment sum accumulated in float32. The plain
    version of `pna_edge_bwd`'s kernel."""
    n = int(num_nodes)
    if proj_i.device.type == "cpu":
        by_recv = by_send = None
    else:
        if layout is None:
            layout = edge_layout(senders, receivers, edge_mask, n)
        if layout_t is None:
            layout_t = edge_layout(receivers, senders, edge_mask, n)
        by_recv, by_send = segment_layouts((layout, layout_t))
    dh, send, recv = edge_grads(proj_i, proj_j, senders, receivers,
                                edge_mask, n, mn, mx, g_s, g_sq, g_min,
                                g_max, by_recv)
    dt = dh.dtype
    dh = dh.float()
    return (segment_sum(dh, recv, n, layout=by_recv).to(dt),
            segment_sum(dh, send, n, layout=by_send).to(dt))


def edge_grads(proj_i, proj_j, senders, receivers, edge_mask, num_nodes,
               mn, mx, g_s, g_sq, g_min, g_max, by_recv=None):
    """(dh [E, F], senders [E] int64, receivers [E] int64): each edge's
    gradient of `pna_edge_vjp` in the projections' dtype, 0 on a dropped
    edge (whose ids are clamped to 0). The tie counts are segment sums
    over the receivers, on the CSR view `by_recv` where given
    (`segment_layouts`)."""
    n = int(num_nodes)
    keep = _kept_edges(senders, receivers, edge_mask, n)[:, None]
    zero = torch.zeros_like(senders)
    send = torch.where(keep[:, 0], senders, zero).long()
    recv = torch.where(keep[:, 0], receivers, zero).long()
    h = proj_i.index_select(0, recv) + proj_j.index_select(0, send)
    dt = h.dtype
    fzero = torch.zeros((), dtype=dt, device=h.device)
    dh = torch.where(keep, g_s.index_select(0, recv)
                     + 2.0 * (h * g_sq.index_select(0, recv)), fzero)
    for g, ext in ((g_min, mn), (g_max, mx)):
        hit = keep & (h == ext.index_select(0, recv))
        ties = segment_sum(hit.float(), recv, n, layout=by_recv)
        share = g / torch.clamp(ties, min=1.0).to(dt)
        dh = dh + torch.where(hit, share.index_select(0, recv), fzero)
    return dh, send, recv


def _bwd_lib(dtype):
    fn = getattr(_build.load("pna_backward"),
                 f"hg_pna_edge_aggregate_bwd_{_build.DTYPE_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def edge_geometry(f, vec, itemsize):
    """(rows per block, threads per row, chunk, dynamic shared bytes) of
    the edge-list backward's pass 1: the dense pass 1's whole-warp rows
    (`nbr.row_geometry`), staging up to STAGE_SLOTS of a receiver's edges
    at once and no slot lists (a receiver's senders lie compact in the
    layout)."""
    return row_geometry(STAGE_SLOTS, f, vec, itemsize, stage=True,
                        lists=False)


def pna_edge_bwd(proj_i, proj_j, senders, receivers, edge_mask, num_nodes,
                 mn, mx, g_s, g_sq, g_min, g_max, layout=None, layout_t=None,
                 edge_pos=None):
    """(dproj_i, dproj_j) of the accumulators, the function of
    `pna_edge_vjp`: the CUDA kernel `csrc/pna_backward.cu` for tensors on
    the card, `pna_edge_vjp` (its plain version) for CPU ones. `layout` /
    `layout_t` are the receiver- and sender-sorted `edge_layout`s of these
    edges and `edge_pos` their `edge_positions`, built here when not
    given. The kernel writes each kept edge's dh to an [E, F] buffer it is
    handed (E rows: a size known without reading the mask, so that the
    call can be captured in a CUDA graph)."""
    global backward_kernel_launches, backward_kernel_bf16_launches
    if proj_i.device.type == "cpu":
        return pna_edge_vjp(proj_i, proj_j, senders, receivers, edge_mask,
                            num_nodes, mn, mx, g_s, g_sq, g_min, g_max,
                            layout, layout_t)
    if proj_i.device.type != "cuda":
        raise ValueError(f"pna_edge_bwd: unsupported device {proj_i.device}")
    n = int(num_nodes)
    f = proj_i.shape[1] if proj_i.dim() == 2 else -1
    rows = (proj_i, proj_j, mn, mx, g_s, g_sq, g_min, g_max)
    if proj_i.dtype not in _build.DTYPE_SUFFIX \
            or any(t.dtype != proj_i.dtype for t in rows):
        raise TypeError("pna_edge_bwd kernel takes float32 or bfloat16 "
                        "projections, extrema and cotangents of one dtype, "
                        f"got {[t.dtype for t in rows]}")
    if any(t.shape != (n, f) for t in rows):
        raise ValueError("pna_edge_bwd: projections, extrema and cotangents "
                         f"must be [{n}, F], got "
                         f"{[tuple(t.shape) for t in rows]}")
    e = senders.shape[0]
    if layout is None:
        layout = edge_layout(senders, receivers, edge_mask, n)
    if layout_t is None:
        layout_t = edge_layout(receivers, senders, edge_mask, n)
    if edge_pos is None:
        edge_pos = edge_positions(layout, layout_t)
    # row_ptr, the senders in receiver order, each edge's dh row, and the
    # sender-sorted layout's row_ptr
    lays = (layout[0], layout[1], edge_pos, layout_t[0])
    if any(t.shape != s for t, s in zip(lays, ((n + 1,), (e,), (e,),
                                               (n + 1,)))) \
            or any(t.dtype != torch.int32 for t in lays):
        raise ValueError("pna_edge_bwd: layouts do not match the edges")
    if any(t.device != proj_i.device for t in rows + lays):
        raise ValueError("pna_edge_bwd: all inputs must be on one device")
    if not all(t.is_contiguous() for t in rows + lays):
        raise ValueError("pna_edge_bwd: inputs must be contiguous")
    # each kept edge's dh, in the sender-sorted layout's order (its first
    # row_ptr[N] rows are written)
    dh = torch.empty((e, f), dtype=proj_i.dtype, device=proj_i.device)
    d_i = torch.empty_like(proj_i)
    d_j = torch.empty_like(proj_i)
    vec = vec_width(f, *rows, dh, d_i, d_j)
    n_rows, _, chunk, smem = edge_geometry(f, vec, proj_i.element_size())
    stream = torch.cuda.current_stream(proj_i.device).cuda_stream
    err = _bwd_lib(proj_i.dtype)(
        *(t.data_ptr() for t in rows + lays), n, e, f, vec, n_rows, chunk,
        smem, *(t.data_ptr() for t in (dh, d_i, d_j)), stream)
    _build.check_launch(err, "pna_edge_aggregate_bwd")
    with COUNTS_LOCK:
        backward_kernel_launches += 2
        if proj_i.dtype == torch.bfloat16:
            backward_kernel_bf16_launches += 2
    return d_i, d_j


class _PnaEdgeAccums(torch.autograd.Function):
    """The accumulators with `pna_edge_bwd` as their backward; forward and
    backward are the kernels for CUDA tensors and the plain versions for
    CPU ones. The mean/std epilogue stays outside, in
    differentiable torch ops, as it stays outside the TPU kernel's
    custom VJP."""

    @staticmethod
    def forward(ctx, proj_i, proj_j, senders, receivers, edge_mask,
                num_nodes, layout, layout_t, edge_pos):
        if proj_i.device.type == "cpu":
            out = pna_edge_accumulators_plain(proj_i, proj_j, senders,
                                              receivers, edge_mask, num_nodes)
        else:
            out = _launch_pna(proj_i, proj_j, num_nodes, layout)
        s, sq, cnt, mn, mx = out
        ctx.save_for_backward(proj_i, proj_j, senders, receivers, edge_mask,
                              mn, mx)
        ctx.num_nodes = num_nodes
        ctx.layouts = (layout, layout_t, edge_pos)
        ctx.mark_non_differentiable(cnt)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_s, g_sq, _g_cnt, g_min, g_max):
        proj_i, proj_j, senders, receivers, edge_mask, mn, mx = \
            ctx.saved_tensors
        d_i, d_j = pna_edge_bwd(proj_i, proj_j, senders, receivers,
                                edge_mask, ctx.num_nodes, mn, mx,
                                g_s.contiguous(), g_sq.contiguous(),
                                g_min.contiguous(), g_max.contiguous(),
                                *ctx.layouts)
        return d_i, d_j, None, None, None, None, None, None, None


def forward_geometry(f, vec, dtype):
    """The forward kernel's receivers a block: FORWARD_ROWS[dtype] on
    whole-warp rows of ceil(F / VEC) threads rounded up to a warp, as many
    as fit a block of 1,024 threads; 0 (flat) where a row alone exceeds
    one."""
    tpr = -(-(f // vec) // 32) * 32
    return min(FORWARD_ROWS[dtype], 1024 // tpr) if tpr <= 1024 else 0


def _launch_pna(proj_i, proj_j, n, layout):
    global launches, bf16_launches
    row_ptr, send_sorted, _ = layout
    f = proj_i.shape[1]
    dev = proj_i.device
    s = torch.empty((n, f), dtype=proj_i.dtype, device=dev)
    sq = torch.empty_like(s)
    mn = torch.empty_like(s)
    mx = torch.empty_like(s)
    cnt = torch.empty((n, 1), dtype=proj_i.dtype, device=dev)
    vec = vec_width(f, proj_i, proj_j, s)
    rows = forward_geometry(f, vec, proj_i.dtype)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib(proj_i.dtype)(proj_i.data_ptr(), proj_j.data_ptr(),
                             send_sorted.data_ptr(), row_ptr.data_ptr(), n, f,
                             vec, rows, s.data_ptr(), sq.data_ptr(),
                             cnt.data_ptr(), mn.data_ptr(), mx.data_ptr(),
                             stream)
    _build.check_launch(err, "pna_edge_aggregate")
    with COUNTS_LOCK:
        launches += 1
        if proj_i.dtype == torch.bfloat16:
            bf16_launches += 1
    return s, sq, cnt, mn, mx


def pna_edge_accumulators(proj_i, proj_j, senders, receivers, edge_mask,
                          num_nodes, layout=None, layout_t=None,
                          edge_pos=None):
    """(s, sq, cnt [N, 1], mn, mx) in the projections' dtype (float32 or
    bfloat16; the sums accumulate in float32) over the kept in-edges of
    each node; mn/mx are 0 on a node without one. `layout` is
    `edge_layout` of these edges, computed here when not given;
    `layout_t`, the sender-sorted one, and `edge_positions` of the two
    are the backward's (built there when not given)."""
    if proj_i.device.type == "cpu":
        return _PnaEdgeAccums.apply(proj_i, proj_j, senders, receivers,
                                    edge_mask, num_nodes, None, None, None)
    if proj_i.device.type != "cuda":
        raise ValueError(f"pna_edge_aggregate: unsupported device "
                         f"{proj_i.device}")
    n = int(num_nodes)
    if (proj_i.dtype not in _build.DTYPE_SUFFIX
            or proj_j.dtype != proj_i.dtype):
        raise TypeError("pna_edge_aggregate kernel takes float32 or bfloat16 "
                        "projections of one dtype, got "
                        f"{proj_i.dtype}/{proj_j.dtype}")
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
    dev = proj_i.device
    if layout is None:
        layout = edge_layout(senders, receivers, edge_mask, n)
    for lay in (layout, layout_t):
        if lay is not None and (
                lay[0].shape != (n + 1,) or lay[1].shape != (e,)
                or lay[0].device != dev or lay[1].device != dev):
            raise ValueError("pna_edge_aggregate: layout does not match "
                             "the edges")
    return _PnaEdgeAccums.apply(proj_i, proj_j, senders, receivers,
                                edge_mask, n, layout, layout_t, edge_pos)


def pna_edge_aggregate(proj_i, proj_j, senders, receivers, edge_mask,
                       num_nodes, eps=1e-5, layout=None, layout_t=None,
                       edge_pos=None):
    """(mean, min, max, std, degree) of proj_i[recv] + proj_j[send] over
    the kept in-edges of each node."""
    return pna_stats_epilogue(
        *pna_edge_accumulators(proj_i, proj_j, senders, receivers,
                               edge_mask, num_nodes, layout, layout_t,
                               edge_pos), eps)


# --------------------------------------------------------------------------
# SchNet continuous-filter aggregation
# --------------------------------------------------------------------------

def filter_scatter_plain(h, w, senders, receivers, edge_mask, num_nodes):
    """sum over the kept edges e into n of h[send[e]] * w[e] -> [N, F]:
    segment_sum_plain(h[send] * w, recv) over the kept edges."""
    keep = _kept_edges(senders, receivers, edge_mask, num_nodes)
    send = torch.where(keep, senders, torch.zeros_like(senders))
    recv = torch.where(keep, receivers, torch.full_like(receivers,
                                                        num_nodes))
    msg = h.index_select(0, send) * w
    msg = torch.where(keep[:, None], msg, torch.zeros_like(msg))
    return segment_sum_plain(msg, recv, num_nodes)


def filter_weight_grad(g, h, senders, receivers, edge_mask, num_nodes,
                       layouts=None):
    """dw of the filter-scatter: g[recv[e]] * h[send[e]] on kept edges, 0
    elsewhere. The two gathers are `gather_rows`, whose gradient (taken
    when a force loss differentiates dw again) is a segment sum on the
    (receiver-sorted, sender-sorted) `layouts` of these edges: no atomic
    scatter, so training repeats bitwise."""
    keep = _kept_edges(senders, receivers, edge_mask, num_nodes)
    zero = torch.zeros_like(senders)
    send = torch.where(keep, senders, zero)
    recv = torch.where(keep, receivers, zero)
    by_recv, by_send = segment_layouts(layouts)
    dw = gather_rows(g, recv, by_recv) * gather_rows(h, send, by_send)
    return torch.where(keep[:, None], dw, torch.zeros_like(dw))


def filter_layouts(senders, receivers, edge_mask, num_nodes):
    """(receiver-sorted, sender-sorted) `edge_layout`s of the edges: the
    forward kernel walks the first, the backward's dh the second; None on
    the CPU."""
    if senders.device.type == "cpu":
        return None
    return (edge_layout(senders, receivers, edge_mask, num_nodes),
            edge_layout(receivers, senders, edge_mask, num_nodes))


def segment_layouts(layouts):
    """(by receiver, by sender) `(row_ptr, order)` CSR views of the kept
    edges from `filter_layouts`, the `layout` a segment sum over
    `receivers` or `senders` takes (kernels.segment.segment_sum); (None,
    None) for None. Masked and out-of-range edges are left out."""
    if layouts is None or layouts[0] is None:
        return None, None
    by_recv, by_send = layouts
    return (by_recv[0], by_recv[2]), (by_send[0], by_send[2])


def _filter_lib(dtype):
    fn = getattr(_build.load("filter_scatter"),
                 f"hg_filter_scatter_{_build.DTYPE_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def _launch_filter(h, w, layout, n, backward):
    global filter_launches, filter_backward_launches
    global filter_bf16_launches, filter_backward_bf16_launches
    row_ptr, send_sorted, order = layout
    f = h.shape[1]
    out = torch.empty((n, f), dtype=h.dtype, device=h.device)
    vec = vec_width(f, h, w, out)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    err = _filter_lib(h.dtype)(h.data_ptr(), w.data_ptr(),
                               send_sorted.data_ptr(), order.data_ptr(),
                               row_ptr.data_ptr(), n, f, vec, out.data_ptr(),
                               stream)
    _build.check_launch(err, "filter_scatter")
    bf16 = h.dtype == torch.bfloat16
    with COUNTS_LOCK:
        if backward:
            filter_backward_launches += 1
            filter_backward_bf16_launches += int(bf16)
        else:
            filter_launches += 1
            filter_bf16_launches += int(bf16)
    return out


class _FilterScatter(torch.autograd.Function):
    """The filter-scatter with the JAX VJP as its backward; the forward is
    the kernel on `layout` for CUDA tensors and the plain version for CPU
    ones. `layout_t` is the transposed (sender-sorted) layout the dh
    call walks; `backward` marks a call made for a gradient, which the
    launch counters keep apart."""

    @staticmethod
    def forward(ctx, h, w, senders, receivers, edge_mask, num_nodes,
                layout, layout_t, backward=False):
        ctx.save_for_backward(h, w, senders, receivers, edge_mask)
        ctx.num_nodes = num_nodes
        ctx.layouts = (layout, layout_t)
        if h.device.type == "cpu":
            return filter_scatter_plain(h, w, senders, receivers, edge_mask,
                                        num_nodes)
        return _launch_filter(h, w, layout, num_nodes, backward)

    @staticmethod
    def backward(ctx, g):
        h, w, senders, receivers, edge_mask = ctx.saved_tensors
        layout, layout_t = ctx.layouts
        n = ctx.num_nodes
        g = g.contiguous()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = _FilterScatter.apply(g, w, receivers, senders, edge_mask, n,
                                      layout_t, layout, True)
        if ctx.needs_input_grad[1]:
            dw = filter_weight_grad(g, h, senders, receivers, edge_mask, n,
                                    ctx.layouts)
        return dh, dw, None, None, None, None, None, None, None


def filter_scatter(h, w, senders, receivers, edge_mask, num_nodes,
                   layout=None):
    """sum over the kept in-edges e of each node of h[send[e]] * w[e], in
    h's dtype (float32, or bfloat16 with bf16 products summed in float32):
    h [N, F], w [E, F] -> [N, F], 0 on a node without a kept edge.
    `layout` is `filter_layouts` of these edges, computed here when not
    given."""
    if h.device.type == "cpu":
        return filter_scatter_plain(h, w, senders, receivers, edge_mask,
                                    num_nodes)
    if h.device.type != "cuda":
        raise ValueError(f"filter_scatter: unsupported device {h.device}")
    n = int(num_nodes)
    if h.dtype not in _build.DTYPE_SUFFIX or w.dtype != h.dtype:
        raise TypeError("filter_scatter kernel takes float32 or bfloat16 h "
                        f"and w of one dtype, got {h.dtype}/{w.dtype}")
    e = senders.shape[0]
    if h.dim() != 2 or h.shape[0] != n or w.dim() != 2 \
            or w.shape != (e, h.shape[1]):
        raise ValueError(f"filter_scatter: h {tuple(h.shape)} and w "
                         f"{tuple(w.shape)} must be [{n}, F] and [{e}, F]")
    if senders.shape != (e,) or receivers.shape != (e,) \
            or edge_mask.shape != (e,):
        raise ValueError("filter_scatter: senders, receivers and edge_mask "
                         "must be [E]")
    if senders.dtype != torch.int32 or receivers.dtype != torch.int32 \
            or edge_mask.dtype != torch.bool:
        raise TypeError("filter_scatter: senders/receivers must be int32 "
                        "and edge_mask bool")
    if any(t.device != h.device for t in (w, senders, receivers, edge_mask)):
        raise ValueError("filter_scatter: all inputs must be on one device")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("filter_scatter: h and w must be contiguous")
    if layout is None:
        layout = filter_layouts(senders, receivers, edge_mask, n)
    for lay in layout:
        if len(lay) != 3 or lay[0].shape != (n + 1,) \
                or lay[1].shape != (e,) or lay[2].shape != (e,) \
                or any(t.device != h.device or t.dtype != torch.int32
                       for t in lay):
            raise ValueError("filter_scatter: layout does not match the "
                             "edges")
    return _FilterScatter.apply(h, w, senders, receivers, edge_mask, n,
                                layout[0], layout[1])
