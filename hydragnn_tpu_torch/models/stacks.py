"""Concrete stacks (counterpart: hydragnn_tpu/models/stacks.py). PNA is
here and SchNet in models/schnet.py; the other stacks follow ROADMAP
item A7."""
from __future__ import annotations

from ..kernels.fused_mp import edge_layout
from .base import BaseStack
from .convs import PNAConv


class PNAStack(BaseStack):

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return PNAConv(in_dim, out_dim, deg_hist=self.cfg.pna_deg,
                       edge_dim=self.cfg.edge_dim)

    def conv_args(self, batch):
        cargs = {"edge_attr": batch.edge_attr}
        if batch.nbr is None:
            # the edge-list kernel's view of the edges, shared by every layer
            cargs["edge_layout"] = edge_layout(batch.senders, batch.receivers,
                                               batch.edge_mask,
                                               batch.num_nodes)
        return cargs
