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

from torch import nn

from ..config.config import ModelConfig
from ..graphs.batch import GraphBatch
from ..ops.activations import activation_function_selection
from ..ops.segment import global_mean_pool
from .layers import MLP, MLPNode, MaskedBatchNorm


class BaseStack(nn.Module):
    """Abstract conv stack + multihead decoder. Subclasses override
    `make_conv` (and optionally `conv_args`)."""

    use_batch_norm = True

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.act = activation_function_selection(cfg.activation)
        in_dim = cfg.input_dim
        for i in range(cfg.num_conv_layers):
            setattr(self, f"conv_{i}",
                    self.make_conv(in_dim, cfg.hidden_dim, i,
                                   final=(i == cfg.num_conv_layers - 1)))
            if self.use_batch_norm:
                setattr(self, f"feature_norm_{i}",
                        MaskedBatchNorm(cfg.hidden_dim))
            in_dim = cfg.hidden_dim
        hidden = cfg.hidden_dim if cfg.num_conv_layers else cfg.input_dim

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
