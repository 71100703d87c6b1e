"""Masked segment ops (counterpart: hydragnn_tpu/ops/segment.py).

Padding is handled by masks, never by dynamic shapes. Reduced-precision
segment sums accumulate in float32 and store back in the data's dtype
(`_accum_f32`). Every floating segment sum of rows (2-D data, or [E, ...]
data summed as [E, prod(...)] rows) goes through
`kernels.segment.segment_sum`: the hand-written kernel for tensors on the
card, its plain version for tensors on the CPU.

SchNet's CFConv aggregation (`filter_weighted_aggregate`) keeps the JAX
routing: on the dense neighbor layout it is the masked K reduction; on
the edge list it goes to `kernels.fused_mp.filter_scatter`, the kernel
for tensors on the card, unconditionally (the JAX package's
HYDRAGNN_FUSED_MP flag and VMEM bound are TPU decisions).

Two "empty segment" conventions coexist, as in the JAX package: the
unfused `segment_min`/`segment_max` fill masked entries with +-1e30 and
clamp empty segments to 0; the fused kernels and `neighbor_aggregate`
clamp through the dtype's finite maximum. Both give 0 on an empty row.
"""
from __future__ import annotations

import functools

import torch

from ..kernels import segment as _seg_kernel
from .scalars import weak


def _accum_f32(data):
    """(float32 data, dtype to cast the result back to or None)."""
    if data.dtype in (torch.bfloat16, torch.float16):
        return data.float(), data.dtype
    return data, None


def sum_accum_f32(data, dim):
    """torch.sum over `dim` under the `_accum_f32` policy: reduced
    precision sums in float32 and is stored back once."""
    data, store_dtype = _accum_f32(data)
    out = torch.sum(data, dim=dim)
    return out if store_dtype is None else out.to(store_dtype)


def sum_slots_in_order(data):
    """Sum over dim 1 of [N, K, ...] data slot after slot (k = 0, 1, ...)
    in float32, stored back in the data's dtype: the order in which the
    dense-layout kernels (csrc/nbr_aggregate.cu, csrc/pna_backward.cu)
    sum a row's slots. Where a row's variance is near 0 the std's
    gradient amplifies the rounding of another order (torch.sum's) by up
    to 2.8e-5 at the csce loader's shape, and on constant rows it flips
    the variance's branch."""
    acc = torch.zeros_like(data[:, 0], dtype=torch.float32)
    for k in range(data.shape[1]):
        acc = acc + data[:, k].float()
    return acc.to(data.dtype)


def _bcast(mask, data):
    """Broadcast a [K] mask against [K, ...] data."""
    return mask.view(tuple(mask.shape) + (1,) * (data.dim() - mask.dim()))


def segment_sum(data, segment_ids, num_segments, mask=None,
                indices_are_sorted=False, layout=None):
    """Masked segment sum; ids outside [0, num_segments) add nothing.
    `indices_are_sorted` promises nondecreasing ids (the pooling case:
    collate lays graphs out in order). `layout` is a CSR view of the ids
    the caller holds (kernels.segment.segment_sum), for data of rows."""
    if mask is not None:
        data = torch.where(_bcast(mask, data), data, torch.zeros_like(data))
    data, store_dtype = _accum_f32(data)
    if data.dim() >= 2 and data.is_floating_point():
        # [E, ...] rows are summed as [E, prod(...)] rows: the vector
        # channels of PAINN / PNAEq ([E, 3, F]) and MACE's per-l
        # messages ([E, mul, 2l+1])
        rest = tuple(data.shape[1:])
        out = _seg_kernel.segment_sum(
            data.reshape(data.shape[0], -1), segment_ids, num_segments,
            indices_are_sorted, layout).reshape((num_segments,) + rest)
    else:
        out = _seg_kernel.segment_sum_plain(data, segment_ids, num_segments)
    return out if store_dtype is None else out.to(store_dtype)


def segment_count(segment_ids, num_segments, mask=None):
    ones = torch.ones(segment_ids.shape[0], dtype=torch.float32,
                      device=segment_ids.device)
    if mask is not None:
        ones = torch.where(mask, ones, torch.zeros_like(ones))
    return _seg_kernel.segment_sum_plain(ones, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments, mask=None,
                 indices_are_sorted=False, layout=None):
    total = segment_sum(data, segment_ids, num_segments, mask,
                        indices_are_sorted=indices_are_sorted, layout=layout)
    count = segment_count(segment_ids, num_segments, mask)
    count = torch.clamp(count, min=1.0)
    return total / count.view(tuple(count.shape) + (1,) * (total.dim() - 1))


class _SegmentExtreme(torch.autograd.Function):
    """scatter_reduce's amax / amin over a `neutral` fill, with
    scatter_reduce's gradient (split evenly among the rows that reach
    their segment's extreme; a segment left at `neutral` counts its fill
    as one more), but gathered by `kernels.segment.gather_rows`: the
    gradient's own gradient (a second derivative: forces under
    create_graph) is then a segment sum in a fixed order, where
    scatter_reduce's is an atomic scatter_add."""

    @staticmethod
    def forward(ctx, data, ids, num_segments, neutral, reduce):
        out = torch.full((num_segments,) + tuple(data.shape[1:]), neutral,
                         dtype=data.dtype, device=data.device)
        out = out.scatter_reduce(0, _bcast(ids, data).expand_as(data), data,
                                 reduce=reduce, include_self=True)
        ctx.save_for_backward(data, ids, out)
        ctx.neutral = neutral
        return out

    @staticmethod
    def backward(ctx, g):
        data, ids, out = ctx.saved_tensors
        hit = data == out.index_select(0, ids)
        count = (out == ctx.neutral).to(g.dtype).index_add(
            0, ids, hit.to(g.dtype))
        rows = _seg_kernel.gather_rows(g / count, ids)
        return (torch.where(hit, rows, torch.zeros_like(rows)), None, None,
                None, None)


def _segment_extreme(data, segment_ids, num_segments, mask, neutral, reduce):
    ids = segment_ids.long()
    valid = (ids >= 0) & (ids < num_segments)
    if mask is not None:
        valid = valid & mask
    fill = torch.full_like(data, neutral)
    data = torch.where(_bcast(valid, data), data, fill)
    ids = torch.where(valid, ids, torch.zeros_like(ids))
    return _SegmentExtreme.apply(data, ids, num_segments, neutral, reduce)


def segment_max(data, segment_ids, num_segments, mask=None, neutral=-1e30):
    out = _segment_extreme(data, segment_ids, num_segments, mask, neutral,
                           "amax")
    # segments with no real entries produce `neutral`; clamp to 0
    return torch.where(out <= neutral, torch.zeros_like(out), out)


def segment_min(data, segment_ids, num_segments, mask=None, neutral=1e30):
    out = _segment_extreme(data, segment_ids, num_segments, mask, neutral,
                           "amin")
    return torch.where(out >= neutral, torch.zeros_like(out), out)


def _relu_tie_half(x):
    """max(x, 0) as JAX's jnp.maximum(x, 0.0) computes it, gradient
    included: half the gradient passes where x == 0 (torch.clamp passes
    all of it); the value is clamp's, bitwise."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def pna_stats_epilogue(s, sq, cnt, mn, mx, eps=1e-5):
    """(mean, min, max, std, degree) from the additive accumulators and
    extrema — the epilogue shared by `pna_aggregate` and the fused edge
    kernel (kernels/fused_mp.py), as on the TPU."""
    cnt_safe = torch.clamp(cnt, min=1.0)
    mean = s / cnt_safe
    var = _relu_tie_half(sq / cnt_safe - mean * mean)
    std = torch.sqrt(var + weak(eps, var))
    return mean, mn, mx, std, cnt[..., 0]


def pna_accumulators(data, segment_ids, num_segments, mask=None,
                     sum_fn=segment_sum):
    """(sum, sum of squares, count, min, max) of `data` per segment: the
    additive statistics ride one segment sum over the [E, 2F + 1]
    concatenation. `sum_fn` is the segment sum to use."""
    f = data.shape[-1]
    ones = torch.ones(tuple(data.shape[:-1]) + (1,), dtype=data.dtype,
                      device=data.device)
    packed = torch.cat([data, data * data, ones], dim=-1)
    if mask is not None:
        packed = torch.where(_bcast(mask, packed), packed,
                             torch.zeros_like(packed))
    packed_sum = sum_fn(packed, segment_ids, num_segments)
    s, sq, cnt = (packed_sum[..., :f], packed_sum[..., f:2 * f],
                  packed_sum[..., 2 * f:])
    mn = segment_min(data, segment_ids, num_segments, mask)
    mx = segment_max(data, segment_ids, num_segments, mask)
    return s, sq, cnt, mn, mx


def pna_aggregate(data, segment_ids, num_segments, mask=None, eps=1e-5,
                  layout=None):
    """PNA aggregation over an edge list -> (mean, min, max, std, degree).
    `layout` is a CSR view of the ids (`segment_sum`) for the sum of the
    statistics, which are 0 on the masked rows it may leave out."""
    return pna_stats_epilogue(*pna_accumulators(
        data, segment_ids, num_segments, mask,
        sum_fn=functools.partial(segment_sum, layout=layout)), eps)


def neighbor_aggregate(h, nbr_mask, eps=1e-5):
    """PNA statistics over the dense neighbor layout: h is [N, K, F]
    per-slot messages, nbr_mask [N, K]. Returns (mean, min, max, std,
    degree) in h's dtype; the sums run in the kernels' slot order and
    reduced precision accumulates in float32 (`sum_slots_in_order`);
    every other op rounds to h's dtype."""
    m = nbr_mask[:, :, None]
    cnt = torch.sum(nbr_mask.to(h.dtype), dim=1)
    cnt_safe = torch.clamp(cnt, min=1.0)[:, None]
    hm = torch.where(m, h, torch.zeros_like(h))
    s = sum_slots_in_order(hm)
    sq = sum_slots_in_order(hm * hm)
    mean = s / cnt_safe
    var = _relu_tie_half(sq / cnt_safe - mean * mean)
    std = torch.sqrt(var + weak(eps, var))
    big = torch.finfo(h.dtype).max
    has = cnt[:, None] > 0
    mn = torch.amin(torch.where(m, h, torch.full_like(h, big)), dim=1)
    mn = torch.where(has, mn, torch.zeros_like(mn))
    mx = torch.amax(torch.where(m, h, torch.full_like(h, -big)), dim=1)
    mx = torch.where(has, mx, torch.zeros_like(mx))
    return mean, mn, mx, std, cnt


def neighbor_sum(h, nbr_mask):
    """Masked sum over the K axis of [N, K, ...] dense-layout messages;
    reduced precision accumulates in float32."""
    m = nbr_mask.view(tuple(nbr_mask.shape) + (1,) * (h.dim() - 2))
    return sum_accum_f32(torch.where(m, h, torch.zeros_like(h)), 1)


def neighbor_mean(h, nbr_mask):
    """Masked mean over the K axis of [N, K, ...] dense-layout messages."""
    cnt = torch.sum(nbr_mask.to(h.dtype), dim=1)
    cnt = cnt.view(tuple(cnt.shape) + (1,) * (h.dim() - 2))
    return neighbor_sum(h, nbr_mask) / torch.clamp(cnt, min=1.0)


def gather_slots(values, nbr, layout=None):
    """values[nbr] for the dense table's [N, K] ids: [N, K, ...]. Its
    gradient is a segment sum by the ids (`kernels.segment.gather_rows`),
    over `layout`, the `segment_layout` of the flattened ids with the
    masked slots left out, when the caller holds one (their gradient is
    0: every dense reduction masks them)."""
    n, k = nbr.shape
    rows = _seg_kernel.gather_rows(values, nbr.reshape(-1), layout)
    return rows.view((n, k) + tuple(values.shape[1:]))


def neighbor_gather_sum(x, batch, layouts=None):
    """Sum over each node's in-edges of its senders' rows, x[send]:
    `neighbor_sum` of the table's gathered neighbours on the dense
    layout, the masked segment sum by receivers on the edge list.
    `layouts` are a stack's `conv_args` views (`aggregation_layouts`)."""
    layouts = layouts or {}
    if batch.nbr is not None:
        return neighbor_sum(gather_slots(x, batch.nbr,
                                         layouts.get("nbr_slot_layout")),
                            batch.nbr_mask)
    return segment_sum(
        _seg_kernel.gather_rows(x, batch.senders, layouts.get("send_layout")),
        batch.receivers, x.shape[0], batch.edge_mask,
        layout=layouts.get("recv_layout"))


def neighbor_gather_mean(x, batch, layouts=None):
    """Mean counterpart of `neighbor_gather_sum`."""
    layouts = layouts or {}
    if batch.nbr is not None:
        return neighbor_mean(gather_slots(x, batch.nbr,
                                          layouts.get("nbr_slot_layout")),
                             batch.nbr_mask)
    return segment_mean(
        _seg_kernel.gather_rows(x, batch.senders, layouts.get("send_layout")),
        batch.receivers, x.shape[0], batch.edge_mask,
        layout=layouts.get("recv_layout"))


def edge_aggregate_sum(edge_values, batch, layout=None):
    """Sum per-edge values into their receivers: the masked K reduction
    of the values gathered by the table's edge ids on the dense layout,
    the masked segment sum on the edge list. `layout` is the
    `segment_layout` of the ids walked: the table's edge ids (for the
    gather's gradient) on the dense layout, the receivers on the edge
    list; either leaves out masked entries, which add nothing."""
    if batch.nbr_edge is not None:
        return neighbor_sum(gather_slots(edge_values, batch.nbr_edge, layout),
                            batch.nbr_mask)
    return segment_sum(edge_values, batch.receivers, batch.num_nodes,
                       batch.edge_mask, layout=layout)


def edge_aggregate_mean(edge_values, batch, layout=None):
    """Mean counterpart of `edge_aggregate_sum`, with its `layout`."""
    if batch.nbr_edge is not None:
        return neighbor_mean(gather_slots(edge_values, batch.nbr_edge,
                                          layout), batch.nbr_mask)
    return segment_mean(edge_values, batch.receivers, batch.num_nodes,
                        batch.edge_mask, layout=layout)


def filter_weighted_aggregate(h, w, batch, layout=None):
    """SchNet's CFConv aggregation: sum over the in-edges e of each node
    of h[send[e]] * w[e]. `layout` is the edge list's
    `kernels.fused_mp.filter_layouts`, shared by the layers of a
    forward."""
    if batch.nbr_edge is not None:
        # gather_rows: the senders' gradient is a segment sum, not an
        # atomic index_add, so a force loss trains the same on every run
        msg = _seg_kernel.gather_rows(h, batch.senders) * w
        return neighbor_sum(msg[batch.nbr_edge], batch.nbr_mask)
    from ..kernels.fused_mp import filter_scatter
    return filter_scatter(h, w, batch.senders, batch.receivers,
                          batch.edge_mask, batch.num_nodes, layout)


def global_mean_pool(node_feats, node_graph, num_graphs, node_mask):
    """Masked graph-level mean pooling; `node_graph` is nondecreasing by
    construction (collate lays graphs out in order, padding nodes last)."""
    return segment_mean(node_feats, node_graph, num_graphs, node_mask,
                        indices_are_sorted=True)


def global_sum_pool(node_feats, node_graph, num_graphs, node_mask):
    """Masked graph-level sum pooling (sorted `node_graph`, as in
    `global_mean_pool`)."""
    return segment_sum(node_feats, node_graph, num_graphs, node_mask,
                       indices_are_sorted=True)


def degree(receivers, num_nodes, edge_mask=None):
    """In-degree per node (float32)."""
    return segment_count(receivers, num_nodes, edge_mask)


def segment_std(data, segment_ids, num_segments, mask=None, eps=1e-5):
    """Per-segment standard deviation sqrt(max(E[x²] - E[x]², 0) + eps)."""
    mean = segment_mean(data, segment_ids, num_segments, mask)
    sq_mean = segment_mean(data * data, segment_ids, num_segments, mask)
    var = _relu_tie_half(sq_mean - mean * mean)
    return torch.sqrt(var + weak(eps, var))


def neighbor_softmax(logits, nbr_mask):
    """Masked softmax over the K axis of [N, K] or [N, K, H] logits:
    attention weights over each node's in-edges, 0 on the masked slots.
    The row maximum is a constant of the gradient, and the masked slots
    are selected away before `exp`, so an all-masked row (maximum
    finfo.min) gives 0 and a finite gradient."""
    m = nbr_mask.view(tuple(nbr_mask.shape) + (1,) * (logits.dim() - 2))
    neg = torch.full((), torch.finfo(logits.dtype).min, dtype=logits.dtype,
                     device=logits.device)
    mx = torch.amax(torch.where(m, logits, neg), dim=1, keepdim=True)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    z = torch.where(m, logits - mx.detach(), zero)
    e = torch.where(m, torch.exp(z), zero)
    denom = torch.sum(e, dim=1, keepdim=True)
    return e / torch.maximum(denom, torch.full((), weak(1e-16, denom),
                                               dtype=denom.dtype,
                                               device=denom.device))


def segment_softmax(logits, segment_ids, num_segments, mask=None,
                    layout=None):
    """Softmax of [E] or [E, H] logits within segments (each receiver's
    in-edges), 0 on masked rows. As in the JAX package the segment
    maximum is not a constant of the gradient: its gradient, 0 but for
    rounding, is shared among the rows that reach it. The per-edge
    gathers' gradients and the denominator are segment sums over
    `layout` (the ids' `segment_layout`) when the caller holds one; on
    the card their backward takes [E, H] logits only (the segment-sum
    kernel sums rows)."""
    neutral = -1e30
    if mask is not None:
        logits = torch.where(_bcast(mask, logits), logits,
                             torch.full_like(logits, neutral))
    seg_max = _segment_extreme(logits, segment_ids, num_segments, None,
                               neutral, "amax")
    seg_max = torch.where(seg_max <= neutral, torch.zeros_like(seg_max),
                          seg_max)
    exp = torch.exp(logits - _seg_kernel.gather_rows(seg_max, segment_ids,
                                                     layout))
    if mask is not None:
        exp = torch.where(_bcast(mask, exp), exp, torch.zeros_like(exp))
    denom = segment_sum(exp, segment_ids, num_segments, layout=layout)
    denom = torch.maximum(denom, torch.full((), weak(1e-16, denom),
                                            dtype=denom.dtype,
                                            device=denom.device))
    return exp / _seg_kernel.gather_rows(denom, segment_ids, layout)
