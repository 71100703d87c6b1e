"""EGNN: E(n)-equivariant graph conv layers (counterpart:
hydragnn_tpu/models/egnn.py, `EGCL` and `EGCLStack`).

Each layer forms a message per edge from [x[recv], x[send], radial,
edge_attr] with the edge MLP, sums the messages into their receivers and
updates the features with the node MLP; with `equivariant` it also moves
the positions by the mean over the in-edges of (vec / (|vec| + 1)) phi,
phi = tanh(coord_mlp(m)) * coords_range clipped to +-100, and the next
layer's edge vectors (PBC shifts included) start from the moved
positions. Two formulations, as in the JAX package: with a cutoff
(`radius` > 0) the radial features are a sinc expansion of the length,
the messages and phi carry a cosine envelope, and the MLPs use SiLU;
without one the radial feature is the raw squared length and the MLPs
use ReLU. The stack has no feature norms.

The edge-list gathers (x and positions by receivers and senders) and
the aggregations (by receivers on the edge list, by the table's edge ids
on the dense layout) walk the `aggregation_layouts` that
`EGCLStack.conv_args` builds once a forward; their gradients are
segment sums (the segment-sum kernel on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import segment as kseg
from ..ops import segment as seg
from ..ops.basis import cosine_cutoff, sinc_expansion
from ..ops.geometry import edge_vectors
from .base import BaseStack, aggregation_layouts
from .layers import MLP


class EGCL(nn.Module):

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 edge_dim: int = 0, equivariant: bool = False,
                 tanh: bool = True, coords_weight: float = 1.0,
                 recurrent: bool = False, cutoff: float = 0.0,
                 num_rbf: int = 16):
        super().__init__()
        self.edge_dim = edge_dim
        self.equivariant = equivariant
        self.tanh = tanh
        self.coords_weight = coords_weight
        self.recurrent = recurrent
        self.cutoff = cutoff
        self.num_rbf = num_rbf
        act = F.silu if cutoff > 0 else F.relu
        radial = num_rbf if cutoff > 0 else 1
        self.edge_mlp = MLP(2 * in_dim + radial + edge_dim,
                            [hidden_dim, hidden_dim], activation=act,
                            activate_final=True)
        if equivariant:
            self.coord_mlp = MLP(hidden_dim, [hidden_dim, 1], activation=act)
            if tanh:
                self.coords_range = nn.Parameter(torch.full((1,), 3.0))
        self.node_mlp = MLP(in_dim + hidden_dim, [hidden_dim, out_dim],
                            activation=act)

    def forward(self, x, pos, batch, cargs):
        recv_l, send_l = cargs.get("recv_layout"), cargs.get("send_layout")
        send, recv = batch.senders, batch.receivers
        vec, length = edge_vectors(pos, send, recv, batch.edge_shifts,
                                   send_layout=send_l, recv_layout=recv_l)
        if self.cutoff > 0:
            radial = sinc_expansion(length, self.cutoff, self.num_rbf)
            envelope = cosine_cutoff(length, self.cutoff)[:, None]
        else:
            radial = (length * length)[:, None]
            envelope = None
        coord_diff = vec / (length + 1.0)[:, None]

        parts = [kseg.gather_rows(x, recv, recv_l),
                 kseg.gather_rows(x, send, send_l), radial]
        if self.edge_dim and batch.edge_attr is not None:
            parts.append(batch.edge_attr)
        m = self.edge_mlp(torch.cat(parts, dim=-1))
        if envelope is not None:
            m = m * envelope
        # the aggregations' layout: the receivers' on the edge list, the
        # table's edge ids' (the gather's gradient) on the dense layout
        agg_layout = (cargs.get("edge_slot_layout") if batch.nbr is not None
                      else recv_l)
        if self.equivariant:
            phi = self.coord_mlp(m)
            if self.tanh:
                phi = torch.tanh(phi) * self.coords_range
            if envelope is not None:
                phi = phi * envelope
            trans = torch.clamp(coord_diff * phi, -100.0, 100.0)
            pos = pos + seg.edge_aggregate_mean(trans, batch, agg_layout) \
                * self.coords_weight
        agg = seg.edge_aggregate_sum(m, batch, agg_layout)
        h = self.node_mlp(torch.cat([x, agg], dim=-1))
        if self.recurrent and h.shape == x.shape:
            h = x + h
        return h, pos


class EGCLStack(BaseStack):
    """radius > 0 selects the sinc + envelope + SiLU formulation (num_radial
    sinc functions, 16 when unset), no radius the raw r² + ReLU one."""
    use_batch_norm = False

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return EGCL(in_dim, out_dim, hidden_dim=self.cfg.hidden_dim,
                    edge_dim=int(self.cfg.edge_dim or 0),
                    equivariant=self.cfg.equivariance,
                    cutoff=float(self.cfg.radius or 0.0),
                    num_rbf=int(self.cfg.num_radial or 16))

    def conv_args(self, batch):
        return aggregation_layouts(batch, edge_slots=True, edge_gathers=True)
