"""MACE: higher-body-order equivariant message passing (counterpart:
hydragnn_tpu/models/mace.py, `LinearIrreps`, `MACEInteraction`,
`MACEProduct`, `MACEReadout`, `process_node_attributes`, `MACEStack`).

Irreps features are {l: [N, mul, 2l+1]} dicts (ops/irreps.py). Positions
are centred per graph; the edges carry real spherical harmonics up to
`max_ell` and a radial basis (`radial_type`, after `distance_transform`)
times a polynomial cutoff. Each layer's interaction is a channel-wise
tensor product of the node features gathered per edge with the
harmonics, weighted per edge and path by an MLP of the radial basis,
summed into the receivers (the per-l messages as [E, mul (2l+1)] rows:
the segment-sum kernel on the edge list) and divided by the average
neighbour count; its product basis adds iterated tensor products up to
the layer's `correlation`, each mixed per l, and a mixed residual. A
readout of the invariant channel after the embedding and after every
layer (linear, but for the last layer's MLP) adds into the outputs.

`LinearIrreps` keeps Flax's parameters as they are: `{prefix}_l{l}`
[mul_in, mul_out], applied through an einsum. Which l each one holds is
fixed by the configuration (`max_ell`, `node_max_ell`, `correlation`):
the stack derives every layer's keys at construction, as Flax finds them
at init (`ops.irreps.tp_output_ls`).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import segment as kseg
from ..ops import segment as seg
from ..ops.activations import activation_function_selection
from ..ops.basis import (DISTANCE_TRANSFORMS, RADIAL_BASES,
                         polynomial_cutoff)
from ..ops.geometry import edge_vectors
from ..ops.irreps import (IrrepsDict, real_spherical_harmonics, scalar_part,
                          tensor_product, tp_output_ls, tp_paths)
from ..ops.scalars import weak
from ..ops.segment import global_mean_pool
from .base import BaseStack, aggregation_layouts, edge_sum_layout
from .layers import MLP, Dense, MLPNode, node_index_in_graph


class LinearIrreps(nn.Module):
    """Per-l channel mixing [N, mul_in, 2l+1] -> [N, mul_out, 2l+1] by
    `{prefix}_l{l}` [mul_in, mul_out], divided by sqrt(mul_in); `ls` are
    the l it holds weights for."""

    def __init__(self, ls: Sequence[int], mul_in: int, mul_out: int,
                 prefix: str = "lin"):
        super().__init__()
        self.prefix = prefix
        for l in sorted(ls):
            setattr(self, f"{prefix}_l{l}",
                    nn.Parameter(torch.empty(mul_in, mul_out)))

    def forward(self, feats: IrrepsDict) -> IrrepsDict:
        out = {}
        for l, f in sorted(feats.items()):
            w = getattr(self, f"{self.prefix}_l{l}")
            out[l] = (torch.einsum("...ui,uv->...vi", f, w)
                      / weak(math.sqrt(f.shape[-2]), f))
        return out


class MACEInteraction(nn.Module):
    """Tensor-product conv with per-edge radial weights; `in_ls` the
    input features' l, `sh_ls` the harmonics'."""

    def __init__(self, mul: int, lmax_out: int, avg_num_neighbors: float,
                 in_ls: Sequence[int], sh_ls: Sequence[int],
                 num_basis: int):
        super().__init__()
        self.mul = mul
        self.lmax_out = lmax_out
        self.avg_num_neighbors = avg_num_neighbors
        in_ls, sh_ls = sorted(in_ls), sorted(sh_ls)
        self.paths = tp_paths(in_ls, sh_ls, lmax_out)
        self.out_ls = tp_output_ls(in_ls, sh_ls, lmax_out)
        self.lin_up = LinearIrreps(in_ls, mul, mul)
        self.radial_weights = MLP(num_basis, [mul, mul * len(self.paths)],
                                  activation=F.silu)
        self.lin_out = LinearIrreps(self.out_ls, mul, mul)

    def forward(self, feats: IrrepsDict, sh: IrrepsDict, radial, batch,
                cargs) -> IrrepsDict:
        h = self.lin_up(feats)
        w = self.radial_weights(radial)                     # [E, P mul]
        w = w.reshape(w.shape[:-1] + (len(self.paths), self.mul))
        weights = {p: w[..., i, :] for i, p in enumerate(self.paths)}
        send_l = cargs.get("send_layout")
        h_e = {l: kseg.gather_rows(f, batch.senders, send_l)
               for l, f in h.items()}
        sh_e = {l: f[:, None, :] for l, f in sh.items()}   # mul-broadcast
        msgs = tensor_product(h_e, sh_e, self.lmax_out, weights)
        layout = edge_sum_layout(batch, cargs)
        agg = {l: seg.edge_aggregate_sum(m, batch, layout)
               / weak(self.avg_num_neighbors, m) for l, m in msgs.items()}
        return self.lin_out(agg)


class MACEProduct(nn.Module):
    """Body-order product basis: `mix_1` of the messages, plus `mix_nu`
    of their nu-fold tensor products up to `correlation`, plus `sc` of
    the residual; `in_ls` the messages' l, `res_ls` the residual's."""

    def __init__(self, mul: int, lmax: int, correlation: int,
                 in_ls: Sequence[int], res_ls: Sequence[int]):
        super().__init__()
        self.lmax = lmax
        self.correlation = correlation
        in_ls = sorted(in_ls)
        self.mix_1 = LinearIrreps(in_ls, mul, mul)
        out = set(in_ls)
        cur = in_ls
        for nu in range(2, correlation + 1):
            cur = tp_output_ls(cur, in_ls, lmax)
            setattr(self, f"mix_{nu}", LinearIrreps(cur, mul, mul))
            out |= set(cur)
        self.sc = LinearIrreps(res_ls, mul, mul)
        self.out_ls = sorted(out)

    def forward(self, a: IrrepsDict, residual: IrrepsDict) -> IrrepsDict:
        total = self.mix_1(a)
        cur = a
        for nu in range(2, self.correlation + 1):
            cur = tensor_product(cur, a, self.lmax)
            mixed = getattr(self, f"mix_{nu}")(cur)
            total = {l: total[l] + mixed[l] if l in total else mixed[l]
                     for l in sorted(set(total) | set(mixed))}
        res = self.sc(residual)
        return {l: (total[l] + res[l]) if l in res else total[l]
                for l in total}


class MACEReadout(nn.Module):
    """Per-layer multihead readout of the invariant channel: a Dense per
    head, or an MLP for the last layer (`nonlinear`); graph heads read
    the masked mean pooling, node heads the nodes. An mlp_per_node head
    is a bank `MLPNode` at every layer; any other node head, a "conv"
    one too, reads as an "mlp" one, as in the JAX package."""

    def __init__(self, cfg, nonlinear: bool, mul: int):
        super().__init__()
        act = activation_function_selection(cfg.activation)
        widen = 1 + cfg.var_output
        for ih, head in enumerate(cfg.heads):
            odim = head.output_dim * widen
            if (head.head_type != "graph"
                    and head.node_arch == "mlp_per_node"):
                mod = MLPNode(mul, head.dim_headlayers, odim,
                              node_type="mlp_per_node", activation=act,
                              num_nodes=max(cfg.num_nodes, 1))
            elif nonlinear:
                mod = MLP(mul, list(head.dim_headlayers) + [odim],
                          activation=act)
            else:
                mod = Dense(mul, odim)
            setattr(self, f"head_{ih}", mod)
        self.heads = list(cfg.heads)

    def forward(self, scalars, batch) -> List[torch.Tensor]:
        pooled = global_mean_pool(scalars, batch.node_graph,
                                  batch.num_graphs, batch.node_mask)
        outs = []
        idx = None
        for ih, head in enumerate(self.heads):
            mod = getattr(self, f"head_{ih}")
            if head.head_type == "graph":
                outs.append(mod(pooled))
            elif isinstance(mod, MLPNode):
                if idx is None:
                    idx = node_index_in_graph(batch.node_graph,
                                              batch.num_graphs)
                outs.append(mod(scalars, idx))
            else:
                outs.append(mod(scalars))
        return outs


def process_node_attributes(x, num_elements: int = 118):
    """One-hot of the first feature as a rounded atomic number clamped
    into [1, num_elements]."""
    z = torch.clamp(torch.round(x[:, 0]), 1, num_elements).long()
    return F.one_hot(z - 1, num_elements).to(x.dtype)


def correlations(cfg) -> tuple:
    corr = cfg.correlation
    if corr is None:
        return (2,)
    if isinstance(corr, int):
        return (corr,)
    return tuple(corr)


class MACEStack(BaseStack):
    """Its own embedding, layers and readouts (no BaseStack decoder):
    hidden_dim channels per l, `max_ell` (1 when unset) harmonics,
    `node_max_ell` (1) features between layers and only l = 0 after the
    last, `num_radial` (8) basis functions of `radial_type` ("bessel")."""

    def __init__(self, cfg):
        nn.Module.__init__(self)
        self.cfg = cfg
        mul = cfg.hidden_dim
        self.lmax = int(cfg.max_ell or 1)
        node_lmax = int(cfg.node_max_ell or 1)
        corr = correlations(cfg)
        self.node_embedding = Dense(cfg.num_elements, mul, bias=False)
        self.readout_0 = MACEReadout(cfg, False, mul)
        feats_ls: List[int] = [0]
        sh_ls = list(range(self.lmax + 1))
        for i in range(cfg.num_conv_layers):
            last = i == cfg.num_conv_layers - 1
            layer_lmax = 0 if last else node_lmax
            inter = MACEInteraction(
                mul, layer_lmax, float(cfg.avg_num_neighbors or 1.0),
                feats_ls, sh_ls, int(cfg.num_radial or 8))
            nu = int(corr[i]) if i < len(corr) else int(corr[-1])
            prod = MACEProduct(mul, layer_lmax, nu, inter.out_ls, feats_ls)
            setattr(self, f"interaction_{i}", inter)
            setattr(self, f"product_{i}", prod)
            setattr(self, f"readout_{i + 1}", MACEReadout(cfg, last, mul))
            feats_ls = prod.out_ls

    def conv_args(self, batch) -> Dict:
        return aggregation_layouts(batch, edge_slots=True, edge_gathers=True)

    def forward(self, batch):
        cfg = self.cfg
        cargs = self.conv_args(batch)
        pos_mean = global_mean_pool(batch.pos, batch.node_graph,
                                    batch.num_graphs, batch.node_mask)
        pos = batch.pos - kseg.gather_rows(pos_mean, batch.node_graph)
        node_attrs = process_node_attributes(batch.x, cfg.num_elements)
        vec, length = edge_vectors(pos, batch.senders, batch.receivers,
                                   batch.edge_shifts,
                                   send_layout=cargs.get("send_layout"),
                                   recv_layout=cargs.get("recv_layout"))
        sh = real_spherical_harmonics(vec, self.lmax)
        cutoff = float(cfg.radius)
        d = DISTANCE_TRANSFORMS[cfg.distance_transform or "None"](length)
        radial = RADIAL_BASES[cfg.radial_type or "bessel"](
            d, cutoff, int(cfg.num_radial or 8))
        radial = radial * polynomial_cutoff(length, cutoff)[:, None]

        feats: IrrepsDict = {0: self.node_embedding(node_attrs)[..., None]}
        outputs = self.readout_0(scalar_part(feats), batch)
        for i in range(cfg.num_conv_layers):
            msg = getattr(self, f"interaction_{i}")(feats, sh, radial, batch,
                                                    cargs)
            feats = getattr(self, f"product_{i}")(msg, feats)
            out_i = getattr(self, f"readout_{i + 1}")(scalar_part(feats),
                                                      batch)
            outputs = [o + oi for o, oi in zip(outputs, out_i)]
        outs, variances = [], []
        for out, head in zip(outputs, cfg.heads):
            outs.append(out[..., :head.output_dim])
            if cfg.var_output:
                variances.append(out[..., head.output_dim:] ** 2)
        return outs, (variances if cfg.var_output else None)
