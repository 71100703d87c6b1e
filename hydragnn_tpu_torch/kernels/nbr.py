"""Fused neighbor-gather -> PNA statistics on the dense neighbor layout —
the port of hydragnn_tpu/kernels/nbr_pallas.py::fused_neighbor_aggregate.

`nbr_aggregate` launches the CUDA kernel `csrc/nbr_aggregate.cu` for
tensors on the card and runs `nbr_aggregate_plain` (the ops/segment.py
formulation, which materializes the [N, K, F] messages) for tensors on the
CPU; a CUDA tensor the kernel does not take raises.

On the H100 the kernel is bound by device-memory bytes: proj_i once, one
proj_j row per real slot (mostly L2 hits: proj_j fits the 50 MB L2 at the
serving shapes), the index/mask tables and five outputs. It never forms
[N, K, F]. A slot whose index lies outside [0, N) counts as masked on both
paths.
"""
from __future__ import annotations

import ctypes

import torch

from ..ops.segment import neighbor_aggregate
from . import _build
from .segment import vec_width

launches = 0


def nbr_aggregate_plain(proj_i, proj_j, nbr, nbr_mask, eps=1e-5):
    """(mean, min, max, std, degree) of proj_i[:, None] + proj_j[nbr] over
    the masked slots."""
    n = proj_j.shape[0]
    idx = nbr.long()
    inside = (idx >= 0) & (idx < n)
    mask = nbr_mask & inside
    idx = torch.where(inside, idx, torch.zeros_like(idx))
    h = proj_i[:, None, :] + proj_j[idx]
    return neighbor_aggregate(h, mask, eps=eps)


def _lib():
    fn = _build.load("nbr_aggregate").hg_nbr_aggregate_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
    return fn


def nbr_aggregate(proj_i, proj_j, nbr, nbr_mask, eps=1e-5):
    """(mean [N, F], min, max, std, degree [N]) of
    proj_i[:, None, :] + proj_j[nbr] over masked slots, without forming
    the [N, K, F] tensor on the card."""
    global launches
    if proj_i.device.type == "cpu":
        return nbr_aggregate_plain(proj_i, proj_j, nbr, nbr_mask, eps)
    if proj_i.device.type != "cuda":
        raise ValueError(f"nbr_aggregate: unsupported device {proj_i.device}")
    n, f = proj_i.shape
    k = nbr.shape[1] if nbr.dim() == 2 else -1
    if proj_i.dtype != torch.float32 or proj_j.dtype != torch.float32:
        raise TypeError("nbr_aggregate kernel takes float32 projections, got "
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
    dev = proj_i.device
    mean = torch.empty((n, f), dtype=torch.float32, device=dev)
    mn = torch.empty_like(mean)
    mx = torch.empty_like(mean)
    sd = torch.empty_like(mean)
    deg = torch.empty((n,), dtype=torch.float32, device=dev)
    vec = vec_width(f, proj_i, proj_j, mean)
    if f // vec > 1024:
        raise ValueError(f"nbr_aggregate: F={f} exceeds the kernel's "
                         "1024 feature groups per block")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(proj_i.data_ptr(), proj_j.data_ptr(), nbr.data_ptr(),
                 nbr_mask.data_ptr(), n, k, f, vec, float(eps),
                 mean.data_ptr(), mn.data_ptr(), mx.data_ptr(), sd.data_ptr(),
                 deg.data_ptr(), stream)
    _build.check_launch(err, "nbr_aggregate")
    launches += 1
    return mean, mn, mx, sd, deg
