"""`BaseStack` — the shared encoder / multihead-decoder pattern
(counterpart: hydragnn_tpu/models/base.py). `model.train()` is the JAX
package's `train=True`: the feature norms normalize with batch statistics
and update their running ones; `model.eval()` uses the running ones.

* encoder: `num_conv_layers` convs (subclass hook `make_conv`), each
  followed by MaskedBatchNorm and the activation;
* decoder: masked mean pooling, one MLP shared by the graph heads
  (`graph_shared`), then per head an MLP (`head_{ih}`), or for a node
  head an "mlp" / "mlp_per_node" `MLPNode` or "conv" head convs;
  GaussianNLL variance widening as in the JAX package.

`Training.conv_checkpointing` recomputes each encoder conv in the
backward (`torch.utils.checkpoint`, the JAX package's `nn.remat`): the
same parameters, outputs and gradients, bit for bit, for less memory.

Outputs at padding slots are garbage but finite; callers read real rows
and graphs only.

Sampled training on one giant graph (preprocess/sampling.py): with
`batch.hist_states` set, the historical cache's slots (`batch.hist_mask`)
take their stale state after each layer but the last, and the feature
norms take their batch statistics over the fresh real slots only. A list
passed as `forward(batch, states=[])` collects each layer's post-layer
state (the JAX package's sown `encoder_h{i}`), which the historical step
writes back into its tables. Stacks that override `encode` or `forward`
(PAINN, PNAEq, MACE) apply neither: `check_hist_encode` refuses them.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config.config import ModelConfig
from ..graphs.batch import GraphBatch
from ..kernels.segment import segment_layout
from ..ops.activations import activation_function_selection
from ..ops.segment import global_mean_pool
from .layers import MLP, Dense, MLPNode, MaskedBatchNorm, node_index_in_graph


def remat_call(conv: nn.Module, *args):
    """`conv(*args)`, its activations recomputed in the backward instead
    of kept (counterpart: hydragnn_tpu/models/base.py::_remat_call).
    Non-reentrant, without saving the RNG state: no stack draws random
    numbers in its forward, and the RNG state's save is not allowed while
    a CUDA graph is captured. The recompute runs the kernels' forwards
    again, so a captured step holds their launches twice."""
    if not torch.is_grad_enabled():
        return conv(*args)
    return checkpoint(conv, *args, use_reentrant=False,
                      preserve_rng_state=False)


class VecHeadConv(nn.Module):
    """A vector-channel conv (`conv(s, v, batch, cargs) -> (s, v)`, PAINN's
    and PNAEq's) as a conv head layer, `(h, pos, batch, cargs) -> (h,
    pos)` (counterpart: hydragnn_tpu/models/base.py::VecHeadConv). The
    channel travels in `cargs["vec_channel"]`, which the decoder resets
    to the encoder's final one at each conv head's start; it restarts
    from zeros where its width is not the features'.

    The wrapped conv is the stack's submodule, not this one's: Flax
    builds it in the stack's scope, so its parameters sit at the top
    level as `{ConvClass}_{k}` (k counting the stack's head convs of that
    class), and `VecHeadConv` holds none."""

    def __init__(self, conv: nn.Module):
        super().__init__()
        # a plain reference: the stack registers the conv under its name
        self.__dict__["conv"] = conv

    def forward(self, h, pos, batch, cargs):
        v = cargs.get("vec_channel")
        if v is None or v.shape[-1] != h.shape[-1]:
            v = torch.zeros((h.shape[0], 3, h.shape[-1]), dtype=h.dtype,
                            device=h.device)
        s, v = self.conv(h, v, batch, cargs)
        cargs["vec_channel"] = v
        return s, pos


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
            odim = head.output_dim * widen
            if head.head_type == "graph":
                mod = MLP(shared_dim, list(head.dim_headlayers) + [odim],
                          activation=self.act)
            elif head.node_arch == "conv":
                self._add_conv_head(ih, hidden, head.dim_headlayers, odim)
                continue
            else:
                mod = MLPNode(hidden, head.dim_headlayers, odim,
                              node_type=head.node_arch, activation=self.act,
                              num_nodes=max(cfg.num_nodes, 1))
            setattr(self, f"head_{ih}", mod)

    def _add_conv_head(self, ih: int, hin: int, dims, odim: int) -> None:
        """A "conv" node head: fresh convs `conv_{num_conv_layers + 100 ih
        + li}` (the JAX package's names), each followed by the masked
        batch norm `head_{ih}_norm_{li}` and the activation, then the
        Dense `head_{ih}_out`. The JAX package departs from the reference
        here on purpose (hydragnn_tpu/models/base.py:185-200: the
        reference's last head conv maps to the output and is normalized
        and activated too), and the port matches the JAX package."""
        for li, hd in enumerate(dims):
            final = li == len(dims) - 1
            idx = self.cfg.num_conv_layers + 100 * ih + li
            setattr(self, f"conv_{idx}",
                    self.make_head_conv(hin, hd, idx, final=final))
            hin = self.conv_width(hin, hd, final)
            setattr(self, f"head_{ih}_norm_{li}", MaskedBatchNorm(hin))
        setattr(self, f"head_{ih}_out", Dense(hin, odim))

    # ------------------------------------------------------------- hooks --
    def make_conv(self, in_dim: int, out_dim: int, idx: int,
                  final: bool = False) -> nn.Module:
        raise NotImplementedError

    def make_head_conv(self, in_dim: int, out_dim: int, idx: int,
                       final: bool = False) -> nn.Module:
        """A conv head's layer (a vector-channel stack wraps its conv in a
        `VecHeadConv`)."""
        return self.make_conv(in_dim, out_dim, idx, final=final)

    def conv_width(self, in_dim: int, out_dim: int, final: bool) -> int:
        """The width of the features a conv made by `make_conv(in_dim,
        out_dim, ..., final)` gives, which its norm and the next conv take
        (Flax infers it from the data): a concatenating GATv2 gives
        heads x out_dim."""
        return out_dim

    def conv_args(self, batch: GraphBatch) -> Dict[str, Any]:
        return {}

    # ------------------------------------------------------------ forward --
    def forward(self, batch: GraphBatch, states: Optional[List] = None):
        """(outputs, outputs_var); `states`, a list, receives each encoder
        layer's post-layer state [N, H] (only `BaseStack.encode`'s)."""
        cargs = self.conv_args(batch)
        if states is None:
            x, pos = self.encode(batch, cargs)
        else:
            x, pos = self.encode(batch, cargs, states)
        return self.decode(x, pos, batch, cargs)

    def encode(self, batch: GraphBatch, cargs, states: Optional[List] = None):
        x, pos = batch.x, batch.pos
        remat = self.cfg.conv_checkpointing
        hist = batch.hist_states is not None and batch.hist_mask is not None
        # the cache's stale slots are constants, not fresh computations:
        # they stay out of the norms' batch statistics
        stats_mask = (batch.node_mask & ~batch.hist_mask if hist
                      else batch.node_mask)
        last = self.cfg.num_conv_layers - 1
        for i in range(self.cfg.num_conv_layers):
            conv = getattr(self, f"conv_{i}")
            if remat:
                x, pos = remat_call(conv, x, pos, batch, cargs)
            else:
                x, pos = conv(x, pos, batch, cargs)
            if self.use_batch_norm:
                x = getattr(self, f"feature_norm_{i}")(x, stats_mask)
            x = self.act(x)
            if hist and i < last:
                x = torch.where(batch.hist_mask[:, None],
                                batch.hist_states[i].to(x.dtype), x)
            if states is not None:
                states.append(x)
        return x, pos

    def decode(self, x, pos, batch: GraphBatch, cargs):
        cfg = self.cfg
        x_graph = global_mean_pool(x, batch.node_graph, batch.num_graphs,
                                   batch.node_mask)
        shared = (self.graph_shared(x_graph)
                  if hasattr(self, "graph_shared") else None)
        outputs: List = []
        outputs_var: List = []
        idx = None
        for ih, head in enumerate(cfg.heads):
            if head.head_type == "graph":
                out = getattr(self, f"head_{ih}")(shared)
            elif head.node_arch == "conv":
                out = self._conv_head(ih, head, x, pos, batch, cargs)
            elif head.node_arch == "mlp_per_node":
                if idx is None:
                    idx = node_index_in_graph(batch.node_graph,
                                              batch.num_graphs)
                out = getattr(self, f"head_{ih}")(x, idx)
            else:
                out = getattr(self, f"head_{ih}")(x)
            outputs.append(out[..., :head.output_dim])
            if cfg.var_output:
                outputs_var.append(out[..., head.output_dim:] ** 2)
        if cfg.var_output:
            return outputs, outputs_var
        return outputs, None

    def _conv_head(self, ih: int, head, h, hpos, batch, cargs):
        if "vec_channel_encoder" in cargs:
            # every conv head starts from the encoder's final vector
            # channel, not the previous head's
            cargs["vec_channel"] = cargs["vec_channel_encoder"]
        for li in range(len(head.dim_headlayers)):
            conv = getattr(self, f"conv_{self.cfg.num_conv_layers + 100 * ih + li}")
            h, hpos = conv(h, hpos, batch, cargs)
            h = getattr(self, f"head_{ih}_norm_{li}")(h, batch.node_mask)
            h = self.act(h)
        return getattr(self, f"head_{ih}_out")(h)


def check_hist_encode(model) -> None:
    """Raise unless `model` applies historical states and hands back its
    post-layer states (`BaseStack.encode` under `BaseStack.forward`).
    PAINN and PNAEq override `encode` and MACE `forward`, as in the JAX
    package, whose historical loss then fails at its missing
    `encoder_h0`; the port refuses them before any work."""
    cls = type(model)
    if cls.encode is not BaseStack.encode or cls.forward is not \
            BaseStack.forward:
        raise ValueError(
            f"historical-embedding mode (staleness_k > 0) needs the shared "
            f"encoder, which applies the cache's stale states layer by "
            f"layer and hands back each layer's fresh state for the "
            f"refresh; {cls.__name__} overrides "
            f"{'encode' if cls.encode is not BaseStack.encode else 'forward'}"
            f" and does neither. Train it with staleness_k 0 (exact "
            f"sampling)")


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
