"""DimeNet++: directional message passing over triplets (counterpart:
hydragnn_tpu/models/dimenet.py, `HydraEmbeddingBlock`,
`InteractionPPBlock`, `OutputPPBlock`, `DimeNetConv`, `DIMEStack`).

Each conv embeds the node features into the edges with a Bessel radial
basis of the edge lengths, runs one interaction block (the k -> j edge
messages gathered per triplet by `idx_kj`, modulated by a spherical basis
of the k -> j length and the triplet's angle at j, summed into the
j -> i edges by `idx_ji`) and one output block (the edge messages summed
into their receivers). The triplet tables ride on the batch
(graphs/triplets.py); the angles and bases are computed from the
positions in the forward, so forces differentiate through them.

The angle is atan2(|a x b|, a . b) with |c| = sqrt(sum(c * c)), as the
JAX package computes it: its gradient at a zero cross product (the
padding triplets, which point at the zero-length padding edge, and any
collinear triplet) is not finite, in both packages and on the CPU and
the card alike. torch.linalg.norm's gradient there would be 0.

The triplet scatter is the segment sum (the segment-sum kernel on the
card), over the triplet tables' `segment_layout`s that `conv_args`
builds once a forward on the card, beside the stack's edge layouts
(`base.aggregation_layouts`); every gather's gradient is a segment sum.
Those layouts keep the padding edge and triplets, so the card's
non-finite entries are the CPU's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import segment as kseg
from ..ops import segment as seg
from ..ops.basis import bessel_basis
from ..ops.geometry import edge_vectors
from ..ops.spherical import spherical_basis
from .base import BaseStack, aggregation_layouts, edge_sum_layout
from .layers import Dense


class HydraEmbeddingBlock(nn.Module):
    """Edge embedding from the node features (no atomic-number table) and
    the radial basis: lin([x[send], x[recv], silu(lin_rbf(rbf))] (+
    silu(lin_edge(edge_attr)))), then SiLU."""

    def __init__(self, hidden: int, num_radial: int, edge_dim: int = 0):
        super().__init__()
        self.edge_dim = edge_dim
        self.lin_rbf = Dense(num_radial, hidden)
        if edge_dim:
            self.lin_edge = Dense(edge_dim, hidden)
        self.lin = Dense((4 if edge_dim else 3) * hidden, hidden)

    def forward(self, x, rbf, batch, cargs):
        parts = [kseg.gather_rows(x, batch.senders,
                                  cargs.get("send_layout")),
                 kseg.gather_rows(x, batch.receivers,
                                  cargs.get("recv_layout")),
                 F.silu(self.lin_rbf(rbf))]
        if self.edge_dim:
            parts.append(F.silu(self.lin_edge(batch.edge_attr)))
        return F.silu(self.lin(torch.cat(parts, dim=-1)))


class InteractionPPBlock(nn.Module):

    def __init__(self, hidden: int, int_emb_size: int, basis_emb_size: int,
                 num_radial: int, num_spherical: int, num_before_skip: int,
                 num_after_skip: int):
        super().__init__()
        self.num_before_skip = num_before_skip
        self.num_after_skip = num_after_skip
        self.lin_ji = Dense(hidden, hidden)
        self.lin_kj = Dense(hidden, hidden)
        self.lin_rbf1 = Dense(num_radial, basis_emb_size, bias=False)
        self.lin_rbf2 = Dense(basis_emb_size, hidden, bias=False)
        self.lin_down = Dense(hidden, int_emb_size)
        self.lin_sbf1 = Dense(num_spherical * num_radial, basis_emb_size,
                              bias=False)
        self.lin_sbf2 = Dense(basis_emb_size, int_emb_size, bias=False)
        self.lin_up = Dense(int_emb_size, hidden)
        for i in range(num_before_skip):
            setattr(self, f"before_skip_{i}", Dense(hidden, hidden))
        self.lin_skip = Dense(hidden, hidden)
        for i in range(num_after_skip):
            setattr(self, f"after_skip_{i}", Dense(hidden, hidden))

    def forward(self, e, rbf, sbf, batch, cargs):
        act = F.silu
        x_ji = act(self.lin_ji(e))
        x_kj = act(self.lin_kj(e))
        x_kj = x_kj * self.lin_rbf2(self.lin_rbf1(rbf))
        x_kj = act(self.lin_down(x_kj))
        sbf_e = self.lin_sbf2(self.lin_sbf1(sbf))
        # the k->j edge messages gathered per triplet, modulated, summed
        # into the j->i edges
        m = kseg.gather_rows(x_kj, batch.idx_kj,
                             cargs.get("kj_layout")) * sbf_e
        agg = seg.segment_sum(m, batch.idx_ji, e.shape[0],
                              batch.triplet_mask,
                              layout=cargs.get("ji_layout"))
        h = x_ji + act(self.lin_up(agg))
        for i in range(self.num_before_skip):
            h = act(getattr(self, f"before_skip_{i}")(h))
        h = act(self.lin_skip(h)) + e
        for i in range(self.num_after_skip):
            h = act(getattr(self, f"after_skip_{i}")(h))
        return h


class OutputPPBlock(nn.Module):

    def __init__(self, hidden: int, out_emb: int, out_dim: int,
                 num_radial: int, num_layers: int = 1):
        super().__init__()
        self.num_layers = num_layers
        self.lin_rbf = Dense(num_radial, hidden, bias=False)
        self.lin_up = Dense(hidden, out_emb, bias=False)
        for i in range(num_layers):
            setattr(self, f"lin_{i}", Dense(out_emb, out_emb))
        self.lin_out = Dense(out_emb, out_dim, bias=False)

    def forward(self, e, rbf, batch, cargs):
        x = seg.edge_aggregate_sum(self.lin_rbf(rbf) * e, batch,
                                   edge_sum_layout(batch, cargs))
        x = self.lin_up(x)
        for i in range(self.num_layers):
            x = F.silu(getattr(self, f"lin_{i}")(x))
        return self.lin_out(x)


class DimeNetConv(nn.Module):
    """lin -> embedding -> interaction -> output."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, cfg_int: dict):
        super().__init__()
        c = cfg_int
        self.lin = Dense(in_dim, hidden)
        self.emb = HydraEmbeddingBlock(hidden, c["num_radial"],
                                       c["edge_dim"])
        self.interaction = InteractionPPBlock(
            hidden, c["int_emb_size"], c["basis_emb_size"], c["num_radial"],
            c["num_spherical"], c["num_before_skip"], c["num_after_skip"])
        self.output = OutputPPBlock(hidden, c["out_emb_size"], out_dim,
                                    c["num_radial"])

    def forward(self, x, pos, batch, cargs):
        x = self.lin(x)
        e = self.emb(x, cargs["rbf"], batch, cargs)
        e = self.interaction(e, cargs["rbf"], cargs["sbf"], batch, cargs)
        return self.output(e, cargs["rbf"], batch, cargs), pos


def _cross(a, b):
    """a x b by components, as jnp.cross computes it."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


class DIMEStack(BaseStack):
    """No feature norms; a conv's hidden width is its input's (its output
    width for a 1-wide input)."""
    use_batch_norm = False

    def make_conv(self, in_dim, out_dim, idx, final=False):
        cfg = self.cfg
        hidden = out_dim if in_dim == 1 else in_dim
        return DimeNetConv(in_dim, hidden, out_dim, dict(
            num_radial=int(cfg.num_radial),
            num_spherical=int(cfg.num_spherical),
            int_emb_size=int(cfg.int_emb_size),
            basis_emb_size=int(cfg.basis_emb_size),
            out_emb_size=int(cfg.out_emb_size),
            num_before_skip=int(cfg.num_before_skip),
            num_after_skip=int(cfg.num_after_skip),
            edge_dim=int(cfg.edge_dim or 0)))

    def conv_args(self, batch):
        """The edges' radial basis, the triplets' angles and spherical
        basis, and the layouts of the edge and triplet gathers and sums."""
        if batch.idx_kj is None:
            raise ValueError(
                "DimeNet needs triplet indices; build loaders with "
                "graphs.triplets.make_triplet_transform")
        cfg = self.cfg
        # every edge and triplet, padding included: the gathers'
        # gradients then sum the padding rows as the CPU's do (NaN at the
        # padding node under an energy-force loss, as in JAX); the sums'
        # masked rows are zeros by their masks
        cargs = aggregation_layouts(batch, edge_slots=True,
                                    edge_gathers=True, every_edge=True)
        if batch.x.device.type != "cpu":
            e = batch.num_edges
            cargs["ji_layout"] = kseg.segment_layout(batch.idx_ji, e)
            if torch.is_grad_enabled():
                cargs["kj_layout"] = kseg.segment_layout(batch.idx_kj, e)
        vec, dist = edge_vectors(batch.pos, batch.senders, batch.receivers,
                                 batch.edge_shifts,
                                 send_layout=cargs.get("send_layout"),
                                 recv_layout=cargs.get("recv_layout"))
        radius = float(cfg.radius)
        num_radial = int(cfg.num_radial)
        env_exp = int(cfg.envelope_exponent or 5)
        cargs["rbf"] = bessel_basis(dist, radius, num_radial, env_exp)
        # vec[e] = pos[send] + shift - pos[recv]: for e2 = (j->i) that is
        # pos_j - pos_i, for e1 = (k->j) pos_k - pos_j; the angle at j lies
        # between pos_i - pos_j and pos_k - pos_j
        kj_l, ji_l = cargs.get("kj_layout"), cargs.get("ji_layout")
        a = -kseg.gather_rows(vec, batch.idx_ji, ji_l)
        b = kseg.gather_rows(vec, batch.idx_kj, kj_l)
        c = _cross(a, b)
        angle = torch.atan2(torch.sqrt(torch.sum(c * c, dim=-1)),
                            torch.sum(a * b, dim=-1))
        d_kj = kseg.gather_rows(dist[:, None], batch.idx_kj, kj_l)[:, 0]
        cargs["sbf"] = spherical_basis(d_kj, angle, radius,
                                       int(cfg.num_spherical), num_radial,
                                       env_exp)
        return cargs
