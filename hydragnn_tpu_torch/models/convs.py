"""Message-passing convolutions of the invariant family (counterpart:
hydragnn_tpu/models/convs.py): GIN, SAGE, GATv2, MFC, CGCNN and PNA
(with PNAPlus's Bessel radial term), each `conv(x, pos, batch, cargs) ->
(x, pos)` with the Flax submodule and parameter names.

Widths are given at construction (Flax infers them from the data): a
conv takes `in_dim` features and gives `out_dim`, but for a
concatenating GATv2 (heads x out_dim) and CGConv (its input width).

Every gather of node or edge rows goes through
`kernels.segment.gather_rows`, whose gradient is a segment sum (the
segment-sum kernel on the card, no atomic index_add), over the
`segment_layout`s the stack's `conv_args` builds once a forward
(`base.aggregation_layouts`); every edge-list aggregation is the masked
segment sum by receivers over the same layout.

PNA's aggregation runs through the port's fused kernels on both batch
layouts: the dense neighbor layout (`batch.nbr` set, the `run_prediction`
default) goes to `kernels.nbr.nbr_aggregate`, the edge list (the
`InferenceEngine` default) to `kernels.fused_mp.pna_edge_aggregate`. Each
launches its CUDA kernel for tensors on the card and its plain version on
the CPU, inside an autograd Function whose backward is the JAX VJP
(training).

With edge features (`edge_dim`, e.g. `edge_features: ["lengths"]`) or
PNAPlus's radial basis (`rbf`) each message gains
`edge_proj(edge_encoder(edge_attr))` and `rbf_proj(rbf_encoder(rbf))`,
and the routing is the JAX package's: no fused kernel (it takes no edge
term), the messages are formed per edge and aggregated unfused. On the
dense layout that is `ops.segment.neighbor_aggregate` over [N, K, F] in
plain torch ops; on the edge list `ops.segment.pna_aggregate`, whose sums
of the packed [E, 2F + 1] statistics are the segment-sum kernel's on the
card.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.fused_mp import pna_edge_aggregate
from ..kernels.nbr import nbr_aggregate
from ..kernels import segment as kseg
from ..ops import segment as seg
from ..ops.activations import softplus
from ..ops.scalars import weak
from ..ops.segment import gather_slots, neighbor_aggregate, pna_aggregate
from .layers import Dense, MLP


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
    each message, with `rbf_dim` (PNAPlus) the radial term
    rbf_proj(rbf_encoder(cargs["rbf"]))."""

    def __init__(self, in_dim: int, out_dim: int, deg_hist: Sequence[int],
                 edge_dim: Optional[int] = None, rbf_dim: int = 0):
        super().__init__()
        self.pre_i = Dense(in_dim, in_dim)
        self.pre_j = Dense(in_dim, in_dim, bias=False)
        self.edge_dim = edge_dim
        if edge_dim:
            self.edge_encoder = Dense(edge_dim, in_dim)
            self.edge_proj = Dense(in_dim, in_dim, bias=False)
        self.rbf_dim = rbf_dim
        if rbf_dim:
            self.rbf_encoder = Dense(rbf_dim, in_dim)
            self.rbf_proj = Dense(in_dim, in_dim, bias=False)
        self.post_nn = Dense(16 * in_dim, out_dim)
        self.lin = Dense(out_dim, out_dim)
        self.avg_lin, self.avg_log = pna_degree_stats(deg_hist)

    def edge_terms(self, batch, cargs):
        """The per-edge [E, F] terms joining each message, in the JAX
        package's order: the edge features', then the radial basis'."""
        terms = []
        if self.edge_dim:
            terms.append(self.edge_proj(self.edge_encoder(
                cargs.get("edge_attr", batch.edge_attr))))
        if self.rbf_dim:
            terms.append(self.rbf_proj(self.rbf_encoder(cargs["rbf"])))
        return terms

    def forward(self, x, pos, batch, cargs):
        proj_i = self.pre_i(x)
        proj_j = self.pre_j(x)
        if "graph_slots" in cargs:
            # the edge list split over the graph slots: each slot forms its
            # chunk's messages (the unfused route's, edge terms included)
            # and `slot_edge_stage` combines the statistics' accumulators
            def messages(sb, sc, pi, pj):
                h = (kseg.gather_rows(pi, sb.receivers, sc.get("recv_layout"))
                     + kseg.gather_rows(pj, sb.senders, sc.get("send_layout")))
                for t in self.edge_terms(sb, sc):
                    h = h + t
                return h
            mean, mn, mx, sd, deg = seg.slot_edge_stage(
                cargs["graph_slots"], messages, proj_i, proj_j, reduce="pna")
        elif self.edge_dim or self.rbf_dim:
            # per-edge messages, aggregated unfused, as the JAX package
            # routes edge terms. The gathers' gradients are segment sums
            # (the segment-sum kernel on the card): no atomic index_add,
            # and not torch's sorted index backward, which walks the dense
            # table's thousands of masked slots on one index one by one.
            # Each sum walks the layout conv_args built once for all
            # layers; the masked rows it leaves out carry no gradient (the
            # statistics mask them)
            terms = self.edge_terms(batch, cargs)
            if batch.nbr is not None:
                h = proj_i[:, None, :] + gather_slots(
                    proj_j, batch.nbr, cargs.get("nbr_slot_layout"))
                for t in terms:
                    h = h + gather_slots(t, batch.nbr_edge,
                                         cargs.get("edge_slot_layout"))
                mean, mn, mx, sd, deg = neighbor_aggregate(h, batch.nbr_mask)
            else:
                recv = cargs.get("recv_layout")
                h = (kseg.gather_rows(proj_i, batch.receivers, recv)
                     + kseg.gather_rows(proj_j, batch.senders,
                                   cargs.get("send_layout")))
                for t in terms:
                    h = h + t
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


class GINConv(nn.Module):
    """x' = MLP((1 + eps) x + sum over in-edges of x[send]); eps is
    trainable and starts at 100."""

    def __init__(self, in_dim: int, out_dim: int, eps_init: float = 100.0):
        super().__init__()
        self.eps = nn.Parameter(torch.tensor(float(eps_init)))
        self.MLP_0 = MLP(in_dim, [out_dim, out_dim], activation=F.relu)

    def forward(self, x, pos, batch, cargs):
        agg = seg.neighbor_gather_sum(x, batch, cargs)
        h = (1.0 + self.eps) * x + agg
        return self.MLP_0(h), pos


class SAGEConv(nn.Module):
    """x' = lin_l(mean over in-edges of x[send]) + lin_r(x)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.lin_l = Dense(in_dim, out_dim)
        self.lin_r = Dense(in_dim, out_dim)

    def forward(self, x, pos, batch, cargs):
        agg = seg.neighbor_gather_mean(x, batch, cargs)
        return self.lin_l(agg) + self.lin_r(x), pos


class GATv2Conv(nn.Module):
    """GATv2 attention: e = leaky_relu(lin_l(x)[recv] + lin_r(x)[send]),
    logits = e . att per head, softmax over each node's in-edges, and
    the heads' sums of alpha * lin_r(x)[send] concatenated ([N, H F]) or,
    with `concat` off (a stack's final conv), averaged ([N, F])."""

    def __init__(self, in_dim: int, out_dim: int, heads: int = 6,
                 negative_slope: float = 0.05, concat: bool = True):
        super().__init__()
        self.heads, self.out_dim = heads, out_dim
        self.negative_slope = negative_slope
        self.concat = concat
        self.lin_l = Dense(in_dim, heads * out_dim)
        self.lin_r = Dense(in_dim, heads * out_dim)
        self.att = nn.Parameter(torch.zeros(1, heads, out_dim))

    def forward(self, x, pos, batch, cargs):
        h, f = self.heads, self.out_dim
        g_l = self.lin_l(x).view(-1, h, f)                 # target / self
        g_r = self.lin_r(x).view(-1, h, f)                 # source
        if batch.nbr is not None:
            # the dense layout: the softmax is a masked reduction over K
            g_nbr = gather_slots(g_r.reshape(-1, h * f), batch.nbr,
                                 cargs.get("nbr_slot_layout")).view(
                x.shape[0], -1, h, f)                      # [N, K, H, F]
            e = F.leaky_relu(g_l[:, None] + g_nbr, self.negative_slope)
            alpha = seg.neighbor_softmax(torch.sum(e * self.att, dim=-1),
                                         batch.nbr_mask)   # [N, K, H]
            out = seg.neighbor_sum(g_nbr * alpha[..., None], batch.nbr_mask)
        else:
            recv = cargs.get("recv_layout")
            g_send = kseg.gather_rows(g_r.reshape(-1, h * f), batch.senders,
                                 cargs.get("send_layout")).view(-1, h, f)
            g_recv = kseg.gather_rows(g_l.reshape(-1, h * f), batch.receivers,
                                 recv).view(-1, h, f)
            e = F.leaky_relu(g_recv + g_send, self.negative_slope)
            alpha = seg.segment_softmax(torch.sum(e * self.att, dim=-1),
                                        batch.receivers, x.shape[0],
                                        batch.edge_mask, layout=recv)
            msgs = (g_send * alpha[..., None]).reshape(-1, h * f)
            out = seg.segment_sum(msgs, batch.receivers, x.shape[0],
                                  batch.edge_mask, layout=recv).view(-1, h, f)
        if self.concat:
            return out.reshape(-1, h * f), pos
        return torch.mean(out, dim=1), pos


class MFConv(nn.Module):
    """Molecular-fingerprint conv with degree-specific weights: banks
    w_l, w_r [max_degree + 1, in, out] and b_l, b_r [max_degree + 1, out]
    picked by each node's in-degree (clipped to max_degree);
    x' = agg w_l[d] + b_l[d] + x w_r[d] + b_r[d] with agg the sum over
    in-edges of x[send]."""

    def __init__(self, in_dim: int, out_dim: int, max_degree: int = 10):
        super().__init__()
        d = max_degree + 1
        self.max_degree = max_degree
        self.w_l = nn.Parameter(torch.zeros(d, in_dim, out_dim))
        self.b_l = nn.Parameter(torch.zeros(d, out_dim))
        self.w_r = nn.Parameter(torch.zeros(d, in_dim, out_dim))
        self.b_r = nn.Parameter(torch.zeros(d, out_dim))

    def forward(self, x, pos, batch, cargs):
        agg = seg.neighbor_gather_sum(x, batch, cargs)
        if batch.nbr is not None:
            deg = torch.sum(batch.nbr_mask, dim=1)
        else:
            deg = seg.degree(batch.receivers, x.shape[0], batch.edge_mask)
        deg = torch.clamp(deg.to(torch.int64), 0, self.max_degree)
        out = (torch.einsum("ni,nio->no", agg, self.w_l[deg]) + self.b_l[deg]
               + torch.einsum("ni,nio->no", x, self.w_r[deg]) + self.b_r[deg])
        return out, pos


class CGConv(nn.Module):
    """Crystal-graph conv: x' = x + sum over in-edges of
    sigmoid(lin_f(z)) * softplus(lin_s(z)), z = [x[recv], x[send],
    edge_attr]; its width is its input's."""

    def __init__(self, in_dim: int, edge_dim: int = 0):
        super().__init__()
        self.edge_dim = edge_dim
        self.lin_f = Dense(2 * in_dim + edge_dim, in_dim)
        self.lin_s = Dense(2 * in_dim + edge_dim, in_dim)

    def forward(self, x, pos, batch, cargs):
        ea = cargs.get("edge_attr", batch.edge_attr)
        width = 0 if ea is None else ea.shape[-1]
        if width != self.edge_dim:
            raise ValueError(f"CGConv was built for {self.edge_dim} edge "
                             f"features, the batch carries {width}")
        if batch.nbr is not None:
            n, k = batch.nbr.shape
            parts = [x[:, None].expand(n, k, x.shape[-1]),
                     gather_slots(x, batch.nbr, cargs.get("nbr_slot_layout"))]
            if ea is not None:
                parts.append(gather_slots(ea, batch.nbr_edge,
                                          cargs.get("edge_slot_layout")))
        else:
            parts = [kseg.gather_rows(x, batch.receivers,
                                      cargs.get("recv_layout")),
                     kseg.gather_rows(x, batch.senders,
                                      cargs.get("send_layout"))]
            if ea is not None:
                parts.append(ea)
        z = torch.cat(parts, dim=-1)
        msg = torch.sigmoid(self.lin_f(z)) * softplus(self.lin_s(z))
        if batch.nbr is not None:
            agg = seg.neighbor_sum(msg, batch.nbr_mask)
        else:
            agg = seg.segment_sum(msg, batch.receivers, x.shape[0],
                                  batch.edge_mask,
                                  layout=cargs.get("recv_layout"))
        return x + agg, pos
