"""PNA convolution (counterpart: hydragnn_tpu/models/convs.py, `PNAConv`
and `pna_degree_stats`).

Aggregation runs through the port's kernels on both batch layouts: the
dense neighbor layout (`batch.nbr` set, the `run_prediction` default) goes
to `kernels.nbr.nbr_aggregate`, the edge list (the `InferenceEngine`
default) to `kernels.fused_mp.pna_edge_aggregate`. Each launches its CUDA
kernel for tensors on the card and its plain version on the CPU, inside
an autograd Function whose backward is the JAX VJP (training).

With edge features (`edge_dim`, e.g. `edge_features: ["lengths"]`) each
message gains `edge_proj(edge_encoder(edge_attr))`, and the routing is
the JAX package's: no fused kernel (it takes no edge term), the messages
are formed per edge and aggregated unfused. On the dense layout that is
`ops.segment.neighbor_aggregate` over [N, K, F] in plain torch ops; on the
edge list `ops.segment.pna_aggregate`, whose sums of the packed
[E, 2F + 1] statistics are the segment-sum kernel's on the card. On both
layouts the gathers' backwards are segment sums (`gather_rows`).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..kernels.fused_mp import pna_edge_aggregate
from ..kernels.nbr import nbr_aggregate
from ..kernels.segment import gather_rows
from ..ops.scalars import weak
from ..ops.segment import neighbor_aggregate, pna_aggregate
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
    per-node projections pre_i(x) + pre_j(x) gathered per edge; with
    `edge_dim` the edge term edge_proj(edge_encoder(edge_attr)) joins
    each message."""

    def __init__(self, in_dim: int, out_dim: int, deg_hist: Sequence[int],
                 edge_dim: Optional[int] = None):
        super().__init__()
        self.pre_i = Dense(in_dim, in_dim)
        self.pre_j = Dense(in_dim, in_dim, bias=False)
        self.edge_dim = edge_dim
        if edge_dim:
            self.edge_encoder = Dense(edge_dim, in_dim)
            self.edge_proj = Dense(in_dim, in_dim, bias=False)
        self.post_nn = Dense(16 * in_dim, out_dim)
        self.lin = Dense(out_dim, out_dim)
        self.avg_lin, self.avg_log = pna_degree_stats(deg_hist)

    def forward(self, x, pos, batch, cargs):
        proj_i = self.pre_i(x)
        proj_j = self.pre_j(x)
        if self.edge_dim:
            # per-edge messages, aggregated unfused, as the JAX package
            # routes edge features
            edge = self.edge_proj(self.edge_encoder(
                cargs.get("edge_attr", batch.edge_attr)))
            # the gathers' gradients are segment sums (the segment-sum
            # kernel on the card): no atomic index_add, and not torch's
            # sorted index backward, which walks the dense table's
            # thousands of masked slots on one index one by one. Each
            # sum walks the layout conv_args built once for all layers;
            # the masked rows it leaves out carry no gradient (the
            # statistics mask them)
            if batch.nbr is not None:
                n, k = batch.nbr.shape
                h = proj_i[:, None, :] + gather_rows(
                    proj_j, batch.nbr.reshape(-1),
                    cargs.get("nbr_slot_layout")).view(n, k, -1)
                h = h + gather_rows(edge, batch.nbr_edge.reshape(-1),
                                    cargs.get("edge_slot_layout")).view(
                    n, k, -1)
                mean, mn, mx, sd, deg = neighbor_aggregate(h, batch.nbr_mask)
            else:
                recv = cargs.get("recv_layout")
                h = (gather_rows(proj_i, batch.receivers, recv)
                     + gather_rows(proj_j, batch.senders,
                                   cargs.get("send_layout")))
                h = h + edge
                mean, mn, mx, sd, deg = pna_aggregate(
                    h, batch.receivers, x.shape[0], batch.edge_mask,
                    layout=recv)
        elif batch.nbr is not None:
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
