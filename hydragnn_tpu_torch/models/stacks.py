"""Concrete stacks (counterpart: hydragnn_tpu/models/stacks.py). PNA is
here and SchNet in models/schnet.py; the other stacks follow ROADMAP
item A7."""
from __future__ import annotations

import torch

from ..kernels.fused_mp import edge_layout, edge_positions
from ..kernels.nbr import neighbor_layout
from ..kernels.segment import segment_layout
from .base import BaseStack
from .convs import PNAConv


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
        `segment_layout`s of the ids its segment sums run over — on the
        edge list the receivers (the statistics, and the receiver gather's
        gradient) and, for gradients, the senders; on the dense layout,
        for gradients, the table's slots by neighbour and by edge id.
        Called unbound (`PNAStack.conv_args(None, batch)`) it gives the
        views without edge features."""
        cargs = {"edge_attr": batch.edge_attr}
        grad = torch.is_grad_enabled()
        if self is not None and self.cfg.edge_dim:
            if batch.x.device.type == "cpu":
                return cargs
            if batch.nbr is None:
                cargs["recv_layout"] = segment_layout(
                    batch.receivers, batch.num_nodes, batch.edge_mask)
                if grad:
                    cargs["send_layout"] = segment_layout(
                        batch.senders, batch.num_nodes, batch.edge_mask)
            elif grad:
                slots = batch.nbr_mask.reshape(-1)
                cargs["nbr_slot_layout"] = segment_layout(
                    batch.nbr.reshape(-1), batch.num_nodes, slots)
                cargs["edge_slot_layout"] = segment_layout(
                    batch.nbr_edge.reshape(-1), batch.num_edges, slots)
            return cargs
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
