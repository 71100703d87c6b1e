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
from ..ops.basis import gaussian_basis
from ..ops.geometry import edge_vectors
from ..ops.scalars import weak
from .base import BaseStack
from .layers import Dense, MLP


def shifted_softplus(x):
    """softplus(x) - log 2, with softplus written out as `jax.nn.softplus`
    computes logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|)) (torch's
    softplus switches to x above 20; on the CPU, torch.logaddexp rounds
    an element differently depending on where it lies in the tensor,
    which would break the engine's batched = single contract). The max
    is torch.maximum, whose gradient at x == 0 is JAX's 0.5; log 2 is
    rounded to x's dtype (ops/scalars.py)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (torch.maximum(x, zero) + torch.log1p(torch.exp(-torch.abs(x)))
            - weak(math.log(2.0), x))


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

    def forward(self, x, pos, batch, cargs):
        d = cargs["edge_length"]
        rbf = gaussian_basis(d, 0.0, self.cutoff, self.num_gaussians)
        c = 0.5 * (torch.cos(d * weak(math.pi, d) / self.cutoff) + 1.0)
        c = torch.where(d <= self.cutoff, c, torch.zeros_like(c))
        w = self.filter_nn(rbf) * c[:, None]

        h = self.lin1(x)
        by_recv, by_send = cargs.get("segment_layout", (None, None))
        if self.equivariant:
            vec, length = edge_vectors(pos, batch.senders, batch.receivers,
                                       batch.edge_shifts, send_layout=by_send,
                                       recv_layout=by_recv)
            coord_diff = vec / (length + 1.0)[:, None]
            phi = self.coord_mlp(w)
            trans = torch.clamp(coord_diff * phi, -100.0, 100.0)
            pos = pos + seg.edge_aggregate_mean(trans, batch, by_recv)

        h = seg.filter_weighted_aggregate(h, w, batch,
                                          cargs.get("filter_layout"))
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
