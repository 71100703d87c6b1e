"""PNA convolution (counterpart: hydragnn_tpu/models/convs.py, `PNAConv`
and `pna_degree_stats`).

Aggregation runs through the port's kernels on both batch layouts: the
dense neighbor layout (`batch.nbr` set, the `run_prediction` default) goes
to `kernels.nbr.nbr_aggregate`, the edge list (the `InferenceEngine`
default) to `kernels.fused_mp.pna_edge_aggregate`. Each launches its CUDA
kernel for tensors on the card and its plain version on the CPU, inside
an autograd Function whose backward is the JAX VJP (training).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..kernels.fused_mp import pna_edge_aggregate
from ..kernels.nbr import nbr_aggregate
from ..ops.scalars import weak
from .layers import Dense


def pna_degree_stats(deg_hist: Sequence[int]):
    """(avg linear degree, avg log degree) from the training in-degree
    histogram."""
    hist = np.asarray(deg_hist, dtype=np.float64)
    total = max(hist.sum(), 1.0)
    degs = np.arange(len(hist))
    avg_lin = float((hist * degs).sum() / total)
    avg_log = float((hist * np.log(degs + 1)).sum() / total)
    return max(avg_lin, 1e-6), max(avg_log, 1e-6)


class PNAConv(nn.Module):
    """Principal Neighbourhood Aggregation: aggregators mean/min/max/std,
    scalers identity/amplification/attenuation/linear, one pre- and one
    post-layer. The message pre-layer Dense([x_i || x_j]) is factored into
    per-node projections pre_i(x) + pre_j(x) gathered per edge."""

    def __init__(self, in_dim: int, out_dim: int, deg_hist: Sequence[int],
                 edge_dim: Optional[int] = None):
        super().__init__()
        if edge_dim:
            raise NotImplementedError(
                "PNAConv with edge features is not ported yet (ROADMAP A4: "
                "the edge_encoder/edge_proj message terms)")
        self.pre_i = Dense(in_dim, in_dim)
        self.pre_j = Dense(in_dim, in_dim, bias=False)
        self.post_nn = Dense(16 * in_dim, out_dim)
        self.lin = Dense(out_dim, out_dim)
        self.avg_lin, self.avg_log = pna_degree_stats(deg_hist)

    def forward(self, x, pos, batch, cargs):
        proj_i = self.pre_i(x)
        proj_j = self.pre_j(x)
        if batch.nbr is not None:
            mean, mn, mx, sd, deg = nbr_aggregate(
                proj_i, proj_j, batch.nbr, batch.nbr_mask,
                layout=cargs.get("nbr_layout"))
        else:
            mean, mn, mx, sd, deg = pna_edge_aggregate(
                proj_i, proj_j, batch.senders, batch.receivers,
                batch.edge_mask, x.shape[0], layout=cargs.get("edge_layout"),
                layout_t=cargs.get("edge_layout_t"),
                edge_pos=cargs.get("edge_pos"))
        aggs = torch.cat([mean, mn, mx, sd], dim=-1)          # [N, 4F]
        logd = torch.log(deg + 1.0)
        # the degree statistics rounded to the data's dtype, and the
        # attenuation divided in float32 (ops/scalars.py)
        avg_log = weak(self.avg_log, logd)
        amp = (logd / avg_log)[:, None]
        att = (avg_log / torch.clamp(logd, min=1e-6).float()).to(
            logd.dtype)[:, None]
        lin = (deg / weak(self.avg_lin, deg))[:, None]
        scaled = torch.cat([aggs, aggs * amp, aggs * att, aggs * lin],
                           dim=-1)                             # [N, 16F]
        out = self.post_nn(scaled)
        out = self.lin(out)
        return out, pos
