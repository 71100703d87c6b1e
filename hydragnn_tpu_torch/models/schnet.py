"""SchNet stack (counterpart: hydragnn_tpu/models/schnet.py):
continuous-filter convolutions with the optional equivariant coordinate
update.

Distances are recomputed from `pos` inside the forward (`conv_args`), so
a gradient flows from the energy to the positions for forces. On the edge
list the filter-weighted aggregation is the `filter_scatter` kernel
(kernels/fused_mp.py); its two layouts (receiver- and sender-sorted) are
built once per forward in `conv_args` and shared by every layer, and by
the segment sums over the same edges: the position gathers' backward
(`edge_vectors`) and the coordinate update's mean, which so sort nothing.

As in the JAX package, `SCFStack` keeps the base stack's BatchNorm after
every conv (`use_batch_norm` is not switched off by `equivariance`), and
the updated positions a conv returns do not reach the heads: the
coordinate update is computed, but no gradient flows through it.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.fused_mp import filter_layouts, segment_layouts
from ..ops import segment as seg
from ..ops.activations import softplus
from ..ops.basis import gaussian_basis
from ..ops.geometry import edge_vectors
from ..ops.scalars import weak
from ..parallel.graph_parallel import sharded_conv_args
from .base import BaseStack
from .layers import Dense, MLP


def shifted_softplus(x):
    """softplus(x) - log 2, with JAX's softplus (`ops.activations.
    softplus`, position-independent rounding, which the engine's
    batched = single contract needs); log 2 is rounded to x's dtype
    (ops/scalars.py)."""
    return softplus(x) - weak(math.log(2.0), x)


class CFConv(nn.Module):
    """Continuous-filter conv and interaction block: lin1 -> filter-
    weighted sum over in-edges -> lin2 -> shifted softplus -> lin_out, with
    the filter W = filter_nn(rbf(d)) * cosine_cutoff(d)."""

    def __init__(self, in_dim: int, out_dim: int, num_filters: int,
                 num_gaussians: int, cutoff: float,
                 equivariant: bool = False):
        super().__init__()
        self.num_gaussians = num_gaussians
        self.cutoff = cutoff
        self.equivariant = equivariant
        self.filter_nn = MLP(num_gaussians, [num_filters, num_filters],
                             activation=shifted_softplus)
        self.lin1 = Dense(in_dim, num_filters, bias=False)
        if equivariant:
            self.coord_mlp = MLP(num_filters, [num_filters, 1],
                                 activation=F.relu)
        self.lin2 = Dense(num_filters, num_filters)
        self.lin_out = Dense(num_filters, out_dim)

    def filter(self, d):
        """The filter W [E, num_filters] of the edge lengths d [E]."""
        rbf = gaussian_basis(d, 0.0, self.cutoff, self.num_gaussians)
        c = 0.5 * (torch.cos(d * weak(math.pi, d) / self.cutoff) + 1.0)
        c = torch.where(d <= self.cutoff, c, torch.zeros_like(c))
        return self.filter_nn(rbf) * c[:, None]

    def coord_terms(self, w, pos, batch, cargs):
        """The coordinate update's per-edge terms [E, 3]."""
        by_recv, by_send = cargs.get("segment_layout", (None, None))
        vec, length = edge_vectors(pos, batch.senders, batch.receivers,
                                   batch.edge_shifts, send_layout=by_send,
                                   recv_layout=by_recv)
        coord_diff = vec / (length + 1.0)[:, None]
        phi = self.coord_mlp(w)
        return torch.clamp(coord_diff * phi, -100.0, 100.0)

    def forward(self, x, pos, batch, cargs):
        if "graph_slots" in cargs:
            return self.forward_slots(x, pos, cargs["graph_slots"])
        w = self.filter(cargs["edge_length"])
        h = self.lin1(x)
        by_recv, _ = cargs.get("segment_layout", (None, None))
        if self.equivariant:
            trans = self.coord_terms(w, pos, batch, cargs)
            pos = pos + seg.edge_aggregate_mean(trans, batch, by_recv)

        h = seg.filter_weighted_aggregate(h, w, batch,
                                          cargs.get("filter_layout"))
        h = self.lin2(h)
        h = shifted_softplus(h)
        h = self.lin_out(h)
        return h, pos

    def forward_slots(self, x, pos, sharded):
        """The conv over the active graph slots: each slot computes its
        edge chunk's filter, the filter-scatter of lin1(x) by it (and the
        coordinate terms' sum and count), the partials added in slot
        order; the node-side layers run once, on the home device."""
        h = self.lin1(x)

        def part(sb, sc, hs, ps):
            w = self.filter(sc["edge_length"])
            agg = seg.filter_weighted_aggregate(hs, w, sb,
                                                sc.get("filter_layout"))
            if not self.equivariant:
                return (agg,)
            by_recv, _ = sc.get("segment_layout", (None, None))
            trans = self.coord_terms(w, ps, sb, sc)
            return (agg,
                    seg.segment_sum(trans, sb.receivers, sb.num_nodes,
                                    sb.edge_mask, layout=by_recv),
                    seg.segment_count(sb.receivers, sb.num_nodes,
                                      sb.edge_mask))
        parts = seg.slot_edge_stage(sharded, part, h, pos)
        h = parts[0]
        if self.equivariant:
            count = torch.clamp(parts[2], min=1.0)
            pos = pos + parts[1] / count.view(-1, 1)
        h = self.lin2(h)
        h = shifted_softplus(h)
        h = self.lin_out(h)
        return h, pos


class SCFStack(BaseStack):

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return CFConv(in_dim, out_dim,
                      num_filters=int(self.cfg.num_filters or 128),
                      num_gaussians=int(self.cfg.num_gaussians or 50),
                      cutoff=float(self.cfg.radius),
                      equivariant=self.cfg.equivariance)

    def conv_args(self, batch):
        sharded = sharded_conv_args(batch, self.edge_args)
        return sharded if sharded is not None else self.edge_args(batch)

    def edge_args(self, batch):
        """The edge lengths and the filter layouts of `batch`'s edges (of
        one edge chunk under a graph axis)."""
        layouts = None
        if batch.nbr is None:
            layouts = filter_layouts(batch.senders, batch.receivers,
                                     batch.edge_mask, batch.num_nodes)
        by_recv, by_send = segment_layouts(layouts)
        if batch.edge_attr is not None and self.cfg.edge_dim:
            length = torch.linalg.norm(batch.edge_attr, dim=-1)
        else:
            _, length = edge_vectors(batch.pos, batch.senders,
                                     batch.receivers, batch.edge_shifts,
                                     send_layout=by_send, recv_layout=by_recv)
        return {"edge_length": length, "filter_layout": layouts,
                "segment_layout": (by_recv, by_send)}
