"""Concrete stacks (counterpart: hydragnn_tpu/models/stacks.py): GIN,
SAGE, GAT, MFC, CGCNN, PNA and PNAPlus here, SchNet in models/schnet.py,
EGNN in models/egnn.py."""
from __future__ import annotations

import torch

from ..kernels.fused_mp import edge_layout, edge_positions
from ..kernels.nbr import neighbor_layout
from ..ops.basis import bessel_basis
from ..ops.geometry import edge_vectors
from ..parallel.graph_parallel import sharded_conv_args
from .base import BaseStack, aggregation_layouts
from .convs import CGConv, GATv2Conv, GINConv, MFConv, PNAConv, SAGEConv


class GINStack(BaseStack):

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return GINConv(in_dim, out_dim)

    def conv_args(self, batch):
        sharded = sharded_conv_args(batch, aggregation_layouts)
        if sharded is not None:
            return sharded
        return aggregation_layouts(batch, nbr_slots=True)


class SAGEStack(GINStack):

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return SAGEConv(in_dim, out_dim)


class MFCStack(GINStack):
    """max_degree is the config's max_neighbours (10 when unset)."""

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return MFConv(in_dim, out_dim,
                      max_degree=int(self.cfg.max_neighbours or 10))


class GATStack(GINStack):
    """GATv2 with 6 heads and negative slope 0.05; every conv but the
    final one concatenates its heads."""
    heads = 6
    negative_slope = 0.05

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return GATv2Conv(in_dim, out_dim, heads=self.heads,
                         negative_slope=self.negative_slope,
                         concat=not final)

    def conv_width(self, in_dim, out_dim, final):
        return out_dim if final else self.heads * out_dim


class CGCNNStack(BaseStack):
    """CGConv keeps its width: create_model sets the hidden width to the
    input's, as the JAX package does."""

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return CGConv(in_dim, edge_dim=int(self.cfg.edge_dim or 0))

    def conv_args(self, batch):
        return {"edge_attr": batch.edge_attr,
                **aggregation_layouts(batch, nbr_slots=True,
                                      edge_slots=batch.edge_attr is not None)}


class PNAStack(BaseStack):

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return PNAConv(in_dim, out_dim, deg_hist=self.cfg.pna_deg,
                       edge_dim=self.cfg.edge_dim)

    def conv_args(self, batch):
        """The kernels' CSR views of the batch's edges, shared by every
        layer (None on the CPU). Without edge features: the edge list's
        receiver-sorted layout, and when gradients are on, the views the
        backwards walk (the sender-sorted edges and each edge's position
        in them; the dense table's slots by neighbour). The positions ride
        as an entry of their own: `edge_layout`'s (row_ptr, senders,
        order) serves the filter-scatter and the segment sums too, which
        need none. With edge features (PNAConv's unfused route): the
        `aggregation_layouts` of its gathers and sums. Called unbound
        (`PNAStack.conv_args(None, batch)`) it gives the views without
        edge features. Under a graph axis (parallel/graph_parallel.py):
        each edge chunk's `aggregation_layouts` and edge features, for
        PNAConv's unfused slot route."""
        if self is not None:
            sharded = sharded_conv_args(
                batch, lambda sb: {"edge_attr": sb.edge_attr,
                                   **aggregation_layouts(sb)})
            if sharded is not None:
                return sharded
        cargs = {"edge_attr": batch.edge_attr}
        if self is not None and self.cfg.edge_dim:
            return {**cargs, **aggregation_layouts(batch, nbr_slots=True,
                                                   edge_slots=True)}
        grad = torch.is_grad_enabled()
        if batch.nbr is None:
            cargs["edge_layout"] = edge_layout(batch.senders, batch.receivers,
                                               batch.edge_mask,
                                               batch.num_nodes)
            if grad:
                cargs["edge_layout_t"] = edge_layout(
                    batch.receivers, batch.senders, batch.edge_mask,
                    batch.num_nodes)
                cargs["edge_pos"] = edge_positions(cargs["edge_layout"],
                                                   cargs["edge_layout_t"])
        elif grad:
            cargs["nbr_layout"] = neighbor_layout(batch.nbr, batch.nbr_mask)
        return cargs


class PNAPlusStack(BaseStack):
    """PNA with a Bessel radial basis of the edge lengths (num_radial,
    envelope_exponent; the lengths recomputed from the positions) in
    every message, on the unfused route."""

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return PNAConv(in_dim, out_dim, deg_hist=self.cfg.pna_deg,
                       edge_dim=self.cfg.edge_dim,
                       rbf_dim=int(self.cfg.num_radial or 6))

    def conv_args(self, batch):
        layouts = aggregation_layouts(batch, nbr_slots=True, edge_slots=True)
        _, length = edge_vectors(batch.pos, batch.senders, batch.receivers,
                                 batch.edge_shifts,
                                 send_layout=layouts.get("send_layout"),
                                 recv_layout=layouts.get("recv_layout"))
        rbf = bessel_basis(length, float(self.cfg.radius),
                           int(self.cfg.num_radial or 6),
                           int(self.cfg.envelope_exponent or 5))
        return {"rbf": rbf, "edge_attr": batch.edge_attr, **layouts}
