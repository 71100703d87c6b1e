"""PNAEq: PAINN-style equivariant message passing with PNA's
degree-scaled aggregation of the scalar messages (counterpart:
hydragnn_tpu/models/pnaeq.py, `degree_scaler_aggregation`,
`PNAEqMessage`, `PNAEqUpdate`, `PNAEqConv`, `PNAEqStack`).

The scalar messages' statistics (mean, min, max, std, degree) come from
the plain reductions the JAX package routes them to, not the fused PNA
kernels (they take no per-edge message): on the dense layout
`ops.segment.neighbor_aggregate` of the messages gathered into the
table, on the edge list `ops.segment.pna_aggregate`, whose sums are the
segment-sum kernel's on the card. The vector channel [N, 3, F] is
summed into the receivers as in PAINN (models/painn.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import segment as kseg
from ..ops import segment as seg
from ..ops.basis import cosine_cutoff, sinc_expansion
from ..ops.geometry import edge_vectors
from ..ops.scalars import const, weak
from .base import aggregation_layouts, edge_sum_layout
from .convs import pna_degree_stats
from .layers import MLP, Dense
from .painn import VectorChannelStack, vector_norm

SCALERS = ("identity", "amplification", "attenuation", "linear",
           "inverse_linear")


def degree_scaler_aggregation(h, batch, deg_hist, scalers=SCALERS,
                              cargs=None):
    """PyG's DegreeScalerAggregation: the 4 statistics of each node's
    in-edge messages h [E, F] concatenated, then one copy scaled by each
    scaler: [N, 4 F len(scalers)]."""
    cargs = cargs or {}
    if batch.nbr_edge is not None:
        mean, mn, mx, sd, deg = seg.neighbor_aggregate(
            seg.gather_slots(h, batch.nbr_edge,
                             cargs.get("edge_slot_layout")), batch.nbr_mask)
    else:
        mean, mn, mx, sd, deg = seg.pna_aggregate(
            h, batch.receivers, batch.num_nodes, batch.edge_mask,
            layout=cargs.get("recv_layout"))
    aggs = torch.cat([mean, mn, mx, sd], dim=-1)
    avg_lin, avg_log = pna_degree_stats(deg_hist)
    logd = torch.log(deg + 1.0)
    parts = []
    for s in scalers:
        if s == "identity":
            parts.append(aggs)
        elif s == "amplification":
            parts.append(aggs * (logd / weak(avg_log, logd))[:, None])
        elif s == "attenuation":
            parts.append(aggs * (const(avg_log, logd)
                                 / torch.clamp(logd, min=1e-6))[:, None])
        elif s == "linear":
            parts.append(aggs * (deg / weak(avg_lin, deg))[:, None])
        elif s == "inverse_linear":
            parts.append(aggs * (const(avg_lin, deg)
                                 / torch.clamp(deg, min=1.0))[:, None])
        else:
            raise ValueError(f"unknown scaler {s}")
    return torch.cat(parts, dim=-1)


class PNAEqMessage(nn.Module):

    def __init__(self, node_size: int, num_radial: int,
                 deg_hist: Sequence[int], edge_dim: Optional[int] = None):
        super().__init__()
        f = node_size
        self.node_size = f
        self.deg_hist = tuple(deg_hist)
        self.edge_dim = edge_dim
        self.rbf_emb = Dense(num_radial, f)
        if edge_dim:
            self.edge_encoder = Dense(edge_dim, f)
        self.pre_nn = Dense((4 if edge_dim else 3) * f, f)
        self.scalar_message_mlp = MLP(f, [f, f, f * 3], activation=F.silu)
        self.rbf_lin = Dense(num_radial, f * 3, bias=False)
        self.post_nn = Dense(f + 4 * f * len(SCALERS), f)

    def forward(self, x, v, batch, rbf, edge_vec, cargs):
        send_l = cargs.get("send_layout")
        parts = [kseg.gather_rows(x, batch.senders, send_l),
                 kseg.gather_rows(x, batch.receivers,
                                  cargs.get("recv_layout")),
                 torch.tanh(self.rbf_emb(rbf))]
        if self.edge_dim:
            parts.append(self.edge_encoder(batch.edge_attr))
        msg = self.pre_nn(torch.cat(parts, dim=-1))
        filt = self.scalar_message_mlp(torch.tanh(msg)) * self.rbf_lin(rbf)
        gate_v, gate_e, msg_s = torch.split(filt, self.node_size, dim=-1)
        msg_v = (kseg.gather_rows(v, batch.senders, send_l)
                 * gate_v[:, None, :]
                 + gate_e[:, None, :] * edge_vec[:, :, None])
        dv = seg.edge_aggregate_sum(msg_v, batch,
                                    edge_sum_layout(batch, cargs))
        agg = degree_scaler_aggregation(msg_s, batch, self.deg_hist,
                                        cargs=cargs)
        dx = self.post_nn(torch.cat([x, agg], dim=-1))
        return x + dx, v + dv


class PNAEqUpdate(nn.Module):

    def __init__(self, node_size: int, last_layer: bool = False):
        super().__init__()
        f = node_size
        self.last_layer = last_layer
        self.update_X = Dense(f, f, bias=False)
        self.update_V = Dense(f, f, bias=False)
        self.update_mlp = MLP(2 * f, [f, f * (2 if last_layer else 3)],
                              activation=F.silu)

    def forward(self, x, v):
        f = x.shape[-1]
        xv = self.update_X(v)
        vv = self.update_V(v)
        out = self.update_mlp(torch.cat([vector_norm(vv), x], dim=-1))
        inner = torch.sum(xv * vv, dim=1)
        if self.last_layer:
            a_xv, a_xx = torch.split(out, f, dim=-1)
            return x + a_xv * inner + a_xx, v
        a_vv, a_xv, a_xx = torch.split(out, f, dim=-1)
        return x + a_xv * inner + a_xx, v + a_vv[:, None, :] * xv


class PNAEqConv(nn.Module):

    def __init__(self, in_dim: int, out_dim: int, num_radial: int,
                 deg_hist: Sequence[int], edge_dim: Optional[int],
                 last_layer: bool = False):
        super().__init__()
        self.last_layer = last_layer
        self.message = PNAEqMessage(in_dim, num_radial, deg_hist, edge_dim)
        self.update = PNAEqUpdate(in_dim, last_layer)
        self.node_embed_0 = Dense(in_dim, out_dim)
        self.node_embed_1 = Dense(out_dim, out_dim)
        if not last_layer:
            self.vec_embed = Dense(in_dim, out_dim, bias=False)

    def forward(self, x, v, batch, cargs):
        x, v = self.message(x, v, batch, cargs["rbf"], cargs["edge_vec"],
                            cargs)
        x, v = self.update(x, v)
        x = self.node_embed_1(torch.tanh(self.node_embed_0(x)))
        if not self.last_layer:
            v = self.vec_embed(v)
        return x, v


class PNAEqStack(VectorChannelStack):
    """num_radial sinc functions (6 when unset) with the cosine cutoff at
    the radius; the degree histogram `pna_deg`."""

    def make_conv(self, in_dim, out_dim, idx, final=False):
        cfg = self.cfg
        return PNAEqConv(in_dim, out_dim, int(cfg.num_radial or 6),
                         cfg.pna_deg, cfg.edge_dim, last_layer=final)

    def conv_args(self, batch):
        cargs = aggregation_layouts(batch, edge_slots=True,
                                    edge_gathers=True)
        vec, dist = edge_vectors(batch.pos, batch.senders, batch.receivers,
                                 batch.edge_shifts,
                                 send_layout=cargs.get("send_layout"),
                                 recv_layout=cargs.get("recv_layout"))
        radius = float(self.cfg.radius)
        rbf = sinc_expansion(dist, radius, int(self.cfg.num_radial or 6))
        cargs.update(rbf=rbf * cosine_cutoff(dist, radius)[:, None],
                     edge_vec=vec / dist[:, None])
        return cargs
