"""`BaseStack` — the shared encoder / multihead-decoder pattern
(counterpart: hydragnn_tpu/models/base.py). `model.train()` is the JAX
package's `train=True`: the feature norms normalize with batch statistics
and update their running ones; `model.eval()` uses the running ones.

* encoder: `num_conv_layers` convs (subclass hook `make_conv`), each
  followed by MaskedBatchNorm and the activation;
* decoder: masked mean pooling, one MLP shared by the graph heads
  (`graph_shared`), then one MLP per head (`head_{ih}`); GaussianNLL
  variance widening as in the JAX package.

Outputs at padding slots are garbage but finite; callers read real rows
and graphs only. Activation checkpointing, the sampled-training
historical states and the vector-channel conv heads come with the slices
that need them.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from ..config.config import ModelConfig
from ..graphs.batch import GraphBatch
from ..kernels.segment import segment_layout
from ..ops.activations import activation_function_selection
from ..ops.segment import global_mean_pool
from .layers import MLP, MLPNode, MaskedBatchNorm


class BaseStack(nn.Module):
    """Abstract conv stack + multihead decoder. Subclasses override
    `make_conv` (and optionally `conv_width`, `conv_args`)."""

    use_batch_norm = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.act = activation_function_selection(cfg.activation)
        in_dim = cfg.input_dim
        for i in range(cfg.num_conv_layers):
            final = i == cfg.num_conv_layers - 1
            setattr(self, f"conv_{i}",
                    self.make_conv(in_dim, cfg.hidden_dim, i, final=final))
            in_dim = self.conv_width(in_dim, cfg.hidden_dim, final)
            if self.use_batch_norm:
                setattr(self, f"feature_norm_{i}", MaskedBatchNorm(in_dim))
        hidden = in_dim

        graph_heads = [h for h in cfg.heads if h.head_type == "graph"]
        shared_dim = hidden
        if graph_heads:
            g0 = graph_heads[0]
            self.graph_shared = MLP(hidden,
                                    [g0.dim_sharedlayers] * g0.num_sharedlayers,
                                    activation=self.act, activate_final=True)
            shared_dim = self.graph_shared.out_dim
        widen = 1 + cfg.var_output
        for ih, head in enumerate(cfg.heads):
            if head.head_type == "graph":
                mod = MLP(shared_dim,
                          list(head.dim_headlayers) + [head.output_dim * widen],
                          activation=self.act)
            else:
                mod = MLPNode(hidden, head.dim_headlayers,
                              head.output_dim * widen, node_type=head.node_arch,
                              activation=self.act)
            setattr(self, f"head_{ih}", mod)

    # ------------------------------------------------------------- hooks --
    def make_conv(self, in_dim: int, out_dim: int, idx: int,
                  final: bool = False) -> nn.Module:
        raise NotImplementedError

    def conv_width(self, in_dim: int, out_dim: int, final: bool) -> int:
        """The width of the features a conv made by `make_conv(in_dim,
        out_dim, ..., final)` gives, which its norm and the next conv take
        (Flax infers it from the data): a concatenating GATv2 gives
        heads x out_dim."""
        return out_dim

    def conv_args(self, batch: GraphBatch) -> Dict[str, Any]:
        return {}

    # ------------------------------------------------------------ forward --
    def forward(self, batch: GraphBatch):
        cargs = self.conv_args(batch)
        x, pos = self.encode(batch, cargs)
        return self.decode(x, pos, batch, cargs)

    def encode(self, batch: GraphBatch, cargs):
        x, pos = batch.x, batch.pos
        for i in range(self.cfg.num_conv_layers):
            x, pos = getattr(self, f"conv_{i}")(x, pos, batch, cargs)
            if self.use_batch_norm:
                x = getattr(self, f"feature_norm_{i}")(x, batch.node_mask)
            x = self.act(x)
        return x, pos

    def decode(self, x, pos, batch: GraphBatch, cargs):
        cfg = self.cfg
        x_graph = global_mean_pool(x, batch.node_graph, batch.num_graphs,
                                   batch.node_mask)
        shared = (self.graph_shared(x_graph)
                  if hasattr(self, "graph_shared") else None)
        outputs: List = []
        outputs_var: List = []
        for ih, head in enumerate(cfg.heads):
            mod = getattr(self, f"head_{ih}")
            out = mod(shared) if head.head_type == "graph" else mod(x)
            outputs.append(out[..., :head.output_dim])
            if cfg.var_output:
                outputs_var.append(out[..., head.output_dim:] ** 2)
        if cfg.var_output:
            return outputs, outputs_var
        return outputs, None


def edge_sum_layout(batch: GraphBatch, cargs) -> Any:
    """The layout of `ops.segment.edge_aggregate_sum` in a forward whose
    `conv_args` holds `aggregation_layouts(..., edge_slots=True)`: the
    receivers' on the edge list, the table's edge ids' (the gather's
    gradient) on the dense layout; None where none was built."""
    return (cargs.get("edge_slot_layout") if batch.nbr is not None
            else cargs.get("recv_layout"))


def aggregation_layouts(batch: GraphBatch, nbr_slots: bool = False,
                        edge_slots: bool = False, edge_gathers: bool = False,
                        every_edge: bool = False) -> Dict[str, Any]:
    """The `kernels.segment.segment_layout`s of the ids one forward's
    sums and gathers walk, built once for all its layers (a stack's
    `conv_args`; capture-safe: no host read); {} on the CPU, where the
    plain versions run. Masked entries are left out: they add nothing,
    and their gradient is 0.

    * the edge list: `recv_layout` (the sums by receivers and the
      receiver gathers' gradient) and, with gradients on,
      `send_layout` (the sender gathers' gradient);
    * the dense layout, with gradients on: `nbr_slot_layout` for a stack
      that gathers node rows into the table (`nbr_slots`),
      `edge_slot_layout` for one that gathers edge rows into it
      (`edge_slots`), and the edge list's two for one that also gathers
      node rows per edge (`edge_gathers`).

    With `every_edge` the edge list's two keep the masked edges: their
    gathers' gradient rows are then summed as the CPU's plain versions
    sum them (DimeNet's padding edge, whose rows are NaN under an
    energy-force loss, as in the JAX package)."""
    if batch.x.device.type == "cpu":
        return {}
    grad = torch.is_grad_enabled()
    n = batch.num_nodes
    out = {}
    dense = batch.nbr is not None
    keep = None if every_edge else batch.edge_mask
    if not dense or (grad and edge_gathers):
        out["recv_layout"] = segment_layout(batch.receivers, n, keep)
    if grad and (not dense or edge_gathers):
        out["send_layout"] = segment_layout(batch.senders, n, keep)
    if dense and grad:
        slots = batch.nbr_mask.reshape(-1)
        if nbr_slots:
            out["nbr_slot_layout"] = segment_layout(batch.nbr.reshape(-1), n,
                                                    slots)
        if edge_slots:
            out["edge_slot_layout"] = segment_layout(
                batch.nbr_edge.reshape(-1), batch.num_edges, slots)
    return out
