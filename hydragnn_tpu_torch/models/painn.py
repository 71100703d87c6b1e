"""PAINN: scalar and vector node channels (counterpart:
hydragnn_tpu/models/painn.py, `PainnMessage`, `PainnUpdate`,
`PainnConv`, `PAINNStack`).

The vector channel is [N, 3, F], zero at the first layer; every Dense on
it acts on the feature axis, with no bias (a bias would break the
channel's rotation equivariance). A message carries a sinc radial filter
with a cosine cutoff, gated scalar and vector parts, and the unit edge
direction divided by the length once more, as the JAX package (and the
reference) do. Both channels' messages are summed into their receivers
(`ops.segment.edge_aggregate_sum`: the segment-sum kernel on the edge
list, the vector channel as [E, 3F] rows), and every per-edge gather's
gradient is a segment sum, over the `aggregation_layouts` that
`conv_args` builds once a forward.

The conv-type node heads thread the encoder's vector channel through
`models.base.VecHeadConv`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import segment as kseg
from ..ops import segment as seg
from ..ops.basis import cosine_cutoff, sinc_expansion
from ..ops.geometry import edge_vectors
from ..ops.scalars import weak
from .base import (BaseStack, VecHeadConv, aggregation_layouts,
                   edge_sum_layout)
from .layers import MLP, Dense


def vector_norm(v, eps: float = 1e-12):
    """sqrt(sum over the 3 components of v² + eps): [N, 3, F] -> [N, F]."""
    return torch.sqrt(torch.sum(v * v, dim=1) + weak(eps, v))


class PainnMessage(nn.Module):

    def __init__(self, node_size: int, edge_size: int, cutoff: float):
        super().__init__()
        self.node_size = node_size
        self.edge_size = edge_size
        self.cutoff = cutoff
        self.filter_layer = Dense(edge_size, node_size * 3)
        self.scalar_message_mlp = MLP(node_size, [node_size, node_size * 3],
                                      activation=F.silu)

    def forward(self, s, v, batch, norm_diff, dist, cargs):
        send_l = cargs.get("send_layout")
        f = self.node_size
        rbf = sinc_expansion(dist, self.cutoff, self.edge_size)
        w = self.filter_layer(rbf) * cosine_cutoff(dist, self.cutoff)[:, None]
        scal = self.scalar_message_mlp(s)
        filt = w * kseg.gather_rows(scal, batch.senders, send_l)
        gate_v, gate_e, msg_s = torch.split(filt, f, dim=-1)
        # the unit direction divided by the length again (kept from the
        # reference, as the JAX package keeps it)
        floor = torch.full((), weak(1e-9, dist), dtype=dist.dtype,
                           device=dist.device)
        direction = norm_diff / torch.maximum(dist, floor)[:, None]
        msg_v = (kseg.gather_rows(v, batch.senders, send_l)
                 * gate_v[:, None, :]
                 + gate_e[:, None, :] * direction[:, :, None])
        layout = edge_sum_layout(batch, cargs)
        ds = seg.edge_aggregate_sum(msg_s, batch, layout)
        dv = seg.edge_aggregate_sum(msg_v, batch, layout)
        return s + ds, v + dv


class PainnUpdate(nn.Module):

    def __init__(self, node_size: int, last_layer: bool = False):
        super().__init__()
        f = node_size
        self.last_layer = last_layer
        self.update_U = Dense(f, f, bias=False)
        self.update_V = Dense(f, f, bias=False)
        self.update_mlp = MLP(2 * f, [f, f * (2 if last_layer else 3)],
                              activation=F.silu)

    def forward(self, s, v):
        f = s.shape[-1]
        uv = self.update_U(v)
        vv = self.update_V(v)
        mlp_out = self.update_mlp(torch.cat([vector_norm(vv), s], dim=-1))
        inner = torch.sum(uv * vv, dim=1)
        if not self.last_layer:
            a_vv, a_sv, a_ss = torch.split(mlp_out, f, dim=-1)
            return s + a_sv * inner + a_ss, v + a_vv[:, None, :] * uv
        a_sv, a_ss = torch.split(mlp_out, f, dim=-1)
        return s + a_sv * inner + a_ss, v


class PainnConv(nn.Module):
    """Message, update, then the Tanh node re-embedding (and the vector
    channel's, but after the last layer)."""

    def __init__(self, in_dim: int, out_dim: int, num_radial: int,
                 cutoff: float, last_layer: bool = False):
        super().__init__()
        self.last_layer = last_layer
        self.message = PainnMessage(in_dim, num_radial, cutoff)
        self.update = PainnUpdate(in_dim, last_layer)
        self.node_embed_0 = Dense(in_dim, out_dim)
        self.node_embed_1 = Dense(out_dim, out_dim)
        if not last_layer:
            self.vec_embed = Dense(in_dim, out_dim, bias=False)

    def forward(self, s, v, batch, cargs):
        s, v = self.message(s, v, batch, cargs["norm_diff"], cargs["dist"],
                            cargs)
        s, v = self.update(s, v)
        s = self.node_embed_1(torch.tanh(self.node_embed_0(s)))
        if not self.last_layer:
            v = self.vec_embed(v)
        return s, v


class VectorChannelStack(BaseStack):
    """A stack whose convs thread a vector channel: conv(s, v, batch,
    cargs) -> (s, v), v starting at zero, the activation after each
    conv, no feature norms. The encoder leaves its final channel in
    `cargs["vec_channel_encoder"]` for the conv heads, whose convs are
    `VecHeadConv`s. Like the JAX package's, this encoder is not
    rematerialized under `conv_checkpointing`."""
    use_batch_norm = False

    def make_head_conv(self, in_dim, out_dim, idx, final=False):
        conv = self.make_conv(in_dim, out_dim, idx, final=final)
        # Flax's name of a conv built in the stack's scope without one
        cls = type(conv).__name__
        k = sum(name.startswith(f"{cls}_") for name, _ in
                self.named_children())
        setattr(self, f"{cls}_{k}", conv)
        return VecHeadConv(conv)

    def encode(self, batch, cargs):
        x = batch.x
        v = torch.zeros((x.shape[0], 3, x.shape[-1]), dtype=x.dtype,
                        device=x.device)
        for i in range(self.cfg.num_conv_layers):
            x, v = getattr(self, f"conv_{i}")(x, v, batch, cargs)
            x = self.act(x)
        cargs["vec_channel_encoder"] = v
        return x, batch.pos


class PAINNStack(VectorChannelStack):
    """num_radial sinc functions (6 when unset), the radius as cutoff."""

    def make_conv(self, in_dim, out_dim, idx, final=False):
        return PainnConv(in_dim, out_dim, int(self.cfg.num_radial or 6),
                         float(self.cfg.radius), last_layer=final)

    def conv_args(self, batch):
        cargs = aggregation_layouts(batch, edge_slots=True,
                                    edge_gathers=True)
        vec, dist = edge_vectors(batch.pos, batch.senders, batch.receivers,
                                 batch.edge_shifts,
                                 send_layout=cargs.get("send_layout"),
                                 recv_layout=cargs.get("recv_layout"))
        cargs.update(norm_diff=vec / dist[:, None], dist=dist)
        return cargs
