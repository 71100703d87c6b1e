"""Fused neighbor-gather -> PNA statistics on the dense neighbor layout —
the port of hydragnn_tpu/kernels/nbr_pallas.py::fused_neighbor_aggregate.

`nbr_aggregate` runs inside `_NbrAggregate`, its autograd Function: the
forward launches the CUDA kernel `csrc/nbr_aggregate.cu` for tensors on
the card and runs `nbr_aggregate_plain` (the ops/segment.py formulation,
which materializes the [N, K, F] messages) for tensors on the CPU; a CUDA
tensor the kernel does not take raises.

Its byte bound on the H100: proj_i once, one proj_j row per real slot
(mostly L2 hits: proj_j fits the 50 MB L2 at the serving shapes), the
index/mask tables and five outputs; it runs at about twice that, paced
by latency and instruction issue, not bytes (PERF.md §6). It never forms
[N, K, F]. A slot whose index lies outside [0, N) counts as masked on both
paths.

The backward is `nbr_aggregate_bwd`: for tensors on the card the CUDA
kernel `csrc/pna_backward.cu` (two launches: by row for dproj_i, writing
each kept slot's dh to its place in the column-sorted layout, then by
neighbour, a streaming in-order sum of those rows for dproj_j; no
atomics; the dh buffer has N K rows, of which the kept slots' are
written), for tensors on the CPU
`nbr_aggregate_vjp`, its plain version: the JAX VJP (a remat through the
unfused reference) in closed form in torch ops, which rebuilds the
[N, K, F] messages and returns dproj_j as the port's segment sum over the
neighbour ids. The layout (`neighbor_layout`) is built once per forward.

Both kernels share one geometry (`csrc/slots.cuh`, `row_geometry`): a
row owns whole warps and its kept slots are compacted into a list in
shared memory; the forward then gathers the listed proj_j rows a few at a
time into registers, the backward's pass 1 stages all of a chunk's rows
in shared memory with asynchronous copies and walks them twice. At bf16
both compute on packed bf16 pairs where F % 4 == 0.

bf16. The kernels have a float32 and a bf16 instantiation, picked by the
projections' dtype (any other dtype raises on the card). At bf16 both
versions round the slot message and its square to bf16, sum in float32
and store the sums once, as the JAX package's default route does
(ops/segment.py `_accum_f32`; its Pallas kernel accumulates in bf16
instead). The backward runs in the compute dtype, with counts and ties
counted exactly in float32 and its sums over the slots in float32.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..ops.scalars import weak
from ..ops.segment import neighbor_aggregate, sum_slots_in_order
from . import COUNTS_LOCK, _build
from .segment import segment_sum, vec_width

launches = 0              # forward kernel launches, either instantiation
bf16_launches = 0         # of which the bf16 instantiation
backward_kernel_launches = 0       # backward kernel launches, 2 a call
backward_kernel_bf16_launches = 0  # of which the bf16 instantiation

# slots the backward's pass 1 stages at once (a chunk): the loader's K =
# 24 in one gather
STAGE_SLOTS = 24
# threads of a block: rows of ceil(F / VEC) threads rounded up to a warp
BLOCK_THREADS = 128
# dynamic shared memory a block may ask for: kMaxDynamicSmem of
# csrc/slots.cuh, less room for the kernels' static arrays
SMEM_BYTES = 232448 - 1024


def nbr_aggregate_plain(proj_i, proj_j, nbr, nbr_mask, eps=1e-5):
    """(mean, min, max, std, degree) of proj_i[:, None] + proj_j[nbr] over
    the masked slots, summed in the kernel's slot order."""
    n = proj_j.shape[0]
    idx = nbr.long()
    inside = (idx >= 0) & (idx < n)
    mask = nbr_mask & inside
    idx = torch.where(inside, idx, torch.zeros_like(idx))
    h = proj_i[:, None, :] + proj_j[idx]
    return neighbor_aggregate(h, mask, eps=eps)


def _lib(dtype):
    fn = getattr(_build.load("nbr_aggregate"),
                 f"hg_nbr_aggregate_{_build.DTYPE_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
    return fn


def row_geometry(k, f, vec, itemsize, stage=False, lists=True):
    """(rows per block, threads per row, chunk, dynamic shared bytes) of a
    kernel on whole-warp rows (`csrc/slots.cuh`) for K slots, F features,
    VEC elements a thread and elements of `itemsize` bytes. A row owns
    ceil(F / VEC) threads rounded up to a warp; a block holds
    BLOCK_THREADS threads' worth of rows (at least one). The dense forward
    (`stage` False) keeps a list of K neighbour ids a row and no chunk
    (0); the backwards' pass 1 (`stage` True) stages up to STAGE_SLOTS
    slots a row at once, fewer where the shared memory runs out, and the
    dense one keeps two lists of K (the edge list's, `lists` False,
    none)."""
    tpr = -(-(f // vec) // 32) * 32
    if tpr > 1024:
        raise ValueError(f"PNA kernels: F={f} exceeds 1024 threads "
                         f"of {vec} features a row")
    rows = max(1, BLOCK_THREADS // tpr)
    lists = rows * k * 4 * (2 if stage else 1) if lists else 0
    if not stage:
        chunk, staged = 0, 0
    else:
        per_slot = rows * f * itemsize
        room = SMEM_BYTES - lists - 15
        chunk = min(max(k, 1), STAGE_SLOTS,
                    room // per_slot if per_slot else 1)
        staged = -(-(rows * chunk * f * itemsize) // 16) * 16
    if (stage and chunk < 1) or lists > SMEM_BYTES:
        raise ValueError(f"PNA kernels: K={k}, F={f} do not fit the "
                         "shared memory of a block")
    return rows, tpr, chunk, staged + lists


def build_neighbor_layout(nbr, nbr_mask):
    """(row_ptr [N + 1] int32, slot ids [N K] int32, slot positions [N K]
    int32) of the [N, K] table, on any device: the kept slots (mask set,
    index in [0, N)) of the flattened table stable-sorted by neighbour id,
    the masked ones after them, so that neighbour j spans [row_ptr[j],
    row_ptr[j + 1]) (slot n K + k sums into nbr[n, k]); and the inverse,
    each kept slot's position in that order (-1 for the others), where the
    backward kernel writes the slot's dh."""
    from .fused_mp import csr_layout
    n, k = nbr.shape
    rows = torch.arange(n, dtype=torch.int32,
                        device=nbr.device).repeat_interleave(k)
    row_ptr, _, order = csr_layout(rows, nbr.reshape(-1),
                                   nbr_mask.reshape(-1), n)
    at = torch.arange(n * k, dtype=torch.int32, device=nbr.device)
    pos = torch.empty_like(at).index_put_(
        (order.long(),), torch.where(at < row_ptr[n], at, -1))
    return row_ptr, order, pos


def neighbor_layout(nbr, nbr_mask):
    """`build_neighbor_layout` on the card, the CSR view (and its
    inverse) the backward kernel walks; the neighbour table is shared by
    every layer, so a forward builds it once. None on the CPU, whose
    plain segment sum needs none."""
    if nbr.device.type == "cpu":
        return None
    return build_neighbor_layout(nbr, nbr_mask)


def nbr_aggregate_vjp(proj_i, proj_j, nbr, nbr_mask, mn, mx, g_mean, g_min,
                      g_max, g_std, eps=1e-5, layout=None):
    """(dproj_i, dproj_j) of `nbr_aggregate`'s (mean, min, max, std) for
    the cotangents g_*, given the forward's min and max: with h =
    proj_i[:, None] + proj_j[nbr], c = max(count, 1) and var_raw = sq / c
    - mean²,

    * dvar = g_std / (2 std), times 1 where var_raw > 0, 0.5 where it is
      0 (the tie of JAX's and torch's maximum(var_raw, 0)), 0 below;
    * ds = (g_mean - 2 dvar mean) / c, dsq = dvar / c;
    * dh = mask (ds + 2 h dsq) + g_min [h == min] / ties + the same for
      max: tied slots share the gradient evenly, as JAX's min/max VJPs
      do;
    * dproj_i = sum over the slots of dh; dproj_j = the segment sum of dh
      over the neighbour ids (`layout`, from `neighbor_layout`, on the
      card; built here when not given).

    The plain version of `nbr_aggregate_bwd`'s kernel. The sums are
    recomputed from h slot after slot, as the forward kernel and the plain
    forward compute them (`sum_slots_in_order`), so the branch of each
    variance tie is the one the forward took; min and max are exact on
    both paths. In bf16 the counts and ties are
    counted in float32 (exact) and each share formed in bf16; the sums
    over the slots and the neighbours accumulate in float32."""
    n = proj_j.shape[0]
    rows, k = nbr.shape
    dh, idx = slot_grads(proj_i, proj_j, nbr, nbr_mask, mn, mx, g_mean,
                         g_min, g_max, g_std, eps)
    d_i = sum_slots_in_order(dh)
    if layout is None:
        layout = neighbor_layout(nbr, nbr_mask)
    # masked slots carry dh = 0: summing them (CPU) or leaving them out
    # (the layout) gives the same dproj_j
    d_j = segment_sum(dh.reshape(rows * k, -1).float(), idx, n,
                      layout=None if layout is None else layout[:2])
    return d_i, d_j.to(dh.dtype)


def slot_grads(proj_i, proj_j, nbr, nbr_mask, mn, mx, g_mean, g_min, g_max,
               g_std, eps=1e-5):
    """(dh [N, K, F], the slots' neighbour ids [N K] int64): each slot's
    gradient of `nbr_aggregate_vjp`, 0 on a masked slot (whose id is
    clamped to 0), in the projections' dtype."""
    n = proj_j.shape[0]
    rows, k = nbr.shape
    idx = nbr.long()
    inside = (idx >= 0) & (idx < n)
    mask = (nbr_mask & inside)[:, :, None]
    idx = torch.where(inside, idx, torch.zeros_like(idx)).reshape(-1)
    h = proj_i[:, None, :] + proj_j.index_select(0, idx).view(rows, k, -1)
    dt = h.dtype
    zero = torch.zeros((), dtype=dt, device=h.device)
    cnt = torch.sum(mask, dim=1, dtype=torch.float32)        # [N, 1]
    c = torch.clamp(cnt, min=1.0).to(dt)
    hm = torch.where(mask, h, zero)
    mean = sum_slots_in_order(hm) / c
    var_raw = sum_slots_in_order(hm * hm) / c - mean * mean
    std = torch.sqrt(torch.maximum(var_raw, zero) + weak(eps, h))
    dvar = g_std / (2.0 * std)
    dvar = torch.where(var_raw > 0, dvar,
                       torch.where(var_raw == 0, dvar * 0.5, zero))
    ds = (g_mean - dvar * mean - dvar * mean) / c
    dsq = dvar / c
    dh = torch.where(mask, ds[:, None, :] + 2.0 * (hm * dsq[:, None, :]),
                     zero)
    for g, ext in ((g_min, mn), (g_max, mx)):
        hit = mask & (h == ext[:, None, :])
        ties = torch.sum(hit, dim=1, dtype=torch.float32)
        share = g / torch.clamp(ties, min=1.0).to(dt)
        dh = dh + torch.where(hit, share[:, None, :], zero)
    return dh, idx


def _bwd_lib(dtype):
    fn = getattr(_build.load("pna_backward"),
                 f"hg_nbr_aggregate_bwd_{_build.DTYPE_SUFFIX[dtype]}")
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def nbr_aggregate_bwd(proj_i, proj_j, nbr, nbr_mask, mn, mx, g_mean, g_min,
                      g_max, g_std, eps=1e-5, layout=None):
    """(dproj_i, dproj_j) of `nbr_aggregate`, the function of
    `nbr_aggregate_vjp`: the CUDA kernel `csrc/pna_backward.cu` for tensors
    on the card, `nbr_aggregate_vjp` (its plain version) for CPU ones.
    `layout` is `neighbor_layout(nbr, nbr_mask)`, built here when not
    given."""
    global backward_kernel_launches, backward_kernel_bf16_launches
    if proj_i.device.type == "cpu":
        return nbr_aggregate_vjp(proj_i, proj_j, nbr, nbr_mask, mn, mx,
                                 g_mean, g_min, g_max, g_std, eps, layout)
    if proj_i.device.type != "cuda":
        raise ValueError(f"nbr_aggregate_bwd: unsupported device "
                         f"{proj_i.device}")
    n, f = proj_i.shape
    k = nbr.shape[1] if nbr.dim() == 2 else -1
    rows = (proj_i, proj_j, mn, mx, g_mean, g_min, g_max, g_std)
    if proj_i.dtype not in _build.DTYPE_SUFFIX \
            or any(t.dtype != proj_i.dtype for t in rows):
        raise TypeError("nbr_aggregate_bwd kernel takes float32 or bfloat16 "
                        "projections, extrema and cotangents of one dtype, "
                        f"got {[t.dtype for t in rows]}")
    if any(t.shape != (n, f) for t in rows) or nbr.shape != (n, k) \
            or nbr_mask.shape != (n, k):
        raise ValueError("nbr_aggregate_bwd: projections, extrema and "
                         "cotangents must be [N, F] and nbr, nbr_mask "
                         f"[N, K], got {[tuple(t.shape) for t in rows]}, "
                         f"{tuple(nbr.shape)}, {tuple(nbr_mask.shape)}")
    if nbr.dtype != torch.int32 or nbr_mask.dtype != torch.bool:
        raise TypeError("nbr_aggregate_bwd: nbr must be int32 and nbr_mask "
                        "bool")
    if layout is None:
        layout = neighbor_layout(nbr, nbr_mask)
    tensors = rows + (nbr, nbr_mask) + tuple(layout)
    if any(t.device != proj_i.device for t in tensors):
        raise ValueError("nbr_aggregate_bwd: all inputs must be on one "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("nbr_aggregate_bwd: inputs must be contiguous")
    row_ptr, slot_ids, slot_pos = layout
    if row_ptr.shape != (n + 1,) or any(
            t.shape != (n * k,) for t in (slot_ids, slot_pos)) or any(
            t.dtype != torch.int32 for t in layout):
        raise ValueError("nbr_aggregate_bwd: layout does not match the "
                         "neighbour table")
    # each kept slot's dh, in the layout's order (the first row_ptr[N]
    # rows are written; N K rows, a bound known without reading the mask)
    dh = torch.empty((n * k, f), dtype=proj_i.dtype, device=proj_i.device)
    d_i = torch.empty_like(proj_i)
    d_j = torch.empty_like(proj_i)
    vec = vec_width(f, *rows, dh, d_i, d_j)
    n_rows, _, chunk, smem = row_geometry(k, f, vec, proj_i.element_size(),
                                          stage=True)
    stream = torch.cuda.current_stream(proj_i.device).cuda_stream
    err = _bwd_lib(proj_i.dtype)(
        *(t.data_ptr() for t in (proj_i, proj_j, nbr, nbr_mask, slot_pos,
                                 row_ptr, mn, mx, g_mean, g_min, g_max,
                                 g_std)),
        n, k, f, vec, n_rows, chunk, smem, weak(eps, proj_i),
        *(t.data_ptr() for t in (dh, d_i, d_j)), stream)
    _build.check_launch(err, "nbr_aggregate_bwd")
    with COUNTS_LOCK:
        backward_kernel_launches += 2
        if proj_i.dtype == torch.bfloat16:
            backward_kernel_bf16_launches += 2
    return d_i, d_j


def _launch(proj_i, proj_j, nbr, nbr_mask, eps):
    global launches, bf16_launches
    n, f = proj_i.shape
    k = nbr.shape[1]
    dev = proj_i.device
    mean = torch.empty((n, f), dtype=proj_i.dtype, device=dev)
    mn = torch.empty_like(mean)
    mx = torch.empty_like(mean)
    sd = torch.empty_like(mean)
    deg = torch.empty((n,), dtype=proj_i.dtype, device=dev)
    vec = vec_width(f, proj_i, proj_j, mean)
    rows, _, _, smem = row_geometry(k, f, vec, proj_i.element_size())
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib(proj_i.dtype)(proj_i.data_ptr(), proj_j.data_ptr(),
                             nbr.data_ptr(), nbr_mask.data_ptr(), n, k, f,
                             vec, rows, smem, weak(eps, proj_i),
                             mean.data_ptr(), mn.data_ptr(), mx.data_ptr(),
                             sd.data_ptr(), deg.data_ptr(), stream)
    _build.check_launch(err, "nbr_aggregate")
    with COUNTS_LOCK:
        launches += 1
        if proj_i.dtype == torch.bfloat16:
            bf16_launches += 1
    return mean, mn, mx, sd, deg


class _NbrAggregate(torch.autograd.Function):
    """`nbr_aggregate` with `nbr_aggregate_bwd` as its backward; forward
    and backward are the kernels for CUDA tensors and the plain versions
    for CPU ones."""

    @staticmethod
    def forward(ctx, proj_i, proj_j, nbr, nbr_mask, eps, layout):
        if proj_i.device.type == "cpu":
            out = nbr_aggregate_plain(proj_i, proj_j, nbr, nbr_mask, eps)
        else:
            out = _launch(proj_i, proj_j, nbr, nbr_mask, eps)
        ctx.save_for_backward(proj_i, proj_j, nbr, nbr_mask, out[1], out[2])
        ctx.eps = eps
        ctx.layout = layout
        ctx.mark_non_differentiable(out[4])
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_mean, g_min, g_max, g_std, _g_deg):
        proj_i, proj_j, nbr, nbr_mask, mn, mx = ctx.saved_tensors
        d_i, d_j = nbr_aggregate_bwd(
            proj_i, proj_j, nbr, nbr_mask, mn, mx, g_mean.contiguous(),
            g_min.contiguous(), g_max.contiguous(), g_std.contiguous(),
            ctx.eps, ctx.layout)
        return d_i, d_j, None, None, None, None


def nbr_aggregate(proj_i, proj_j, nbr, nbr_mask, eps=1e-5, layout=None):
    """(mean [N, F], min, max, std, degree [N]), in the projections'
    dtype, of proj_i[:, None, :] + proj_j[nbr] over masked slots,
    without forming the [N, K, F] tensor on the card's forward. `layout` is
    `neighbor_layout(nbr, nbr_mask)` for the backward, built there when
    not given."""
    if proj_i.device.type == "cpu":
        return _NbrAggregate.apply(proj_i, proj_j, nbr, nbr_mask, eps, None)
    if proj_i.device.type != "cuda":
        raise ValueError(f"nbr_aggregate: unsupported device {proj_i.device}")
    n, f = proj_i.shape
    k = nbr.shape[1] if nbr.dim() == 2 else -1
    if proj_i.dtype not in _build.DTYPE_SUFFIX or proj_j.dtype != proj_i.dtype:
        raise TypeError("nbr_aggregate kernel takes float32 or bfloat16 "
                        "projections of one dtype, got "
                        f"{proj_i.dtype}/{proj_j.dtype}")
    if proj_j.shape != proj_i.shape or nbr.shape != (n, k) \
            or nbr_mask.shape != (n, k):
        raise ValueError(
            f"nbr_aggregate: proj_i {tuple(proj_i.shape)}, proj_j "
            f"{tuple(proj_j.shape)}, nbr {tuple(nbr.shape)}, mask "
            f"{tuple(nbr_mask.shape)} must be [N, F], [N, F], [N, K], [N, K]")
    if nbr.dtype != torch.int32 or nbr_mask.dtype != torch.bool:
        raise TypeError("nbr_aggregate: nbr must be int32 and nbr_mask bool")
    tensors = (proj_i, proj_j, nbr, nbr_mask)
    if any(t.device != proj_i.device for t in tensors):
        raise ValueError("nbr_aggregate: all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("nbr_aggregate: inputs must be contiguous")
    return _NbrAggregate.apply(proj_i, proj_j, nbr, nbr_mask, eps, layout)
