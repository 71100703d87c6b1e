"""Config-reachable pipeline parallelism, `Training.pipeline_stages`
(counterpart: hydragnn_tpu/parallel/pipeline_trainer.py).

The pipelined model is a homogeneous stack (`PipelineModel`, an
`nn.Module` of `embed`, `convs` and `heads`):

    embed Dense(in -> hidden)                          [stage 0's device]
    L x (conv -> LayerNorm -> activation)              [stage s's device]
    graph-pool MLP heads / mlp node heads              [stage 0's device]

with the conv kinds `PIPELINE_CONV_TYPES` (GIN, SAGE, PNA, SchNet,
equivariant SchNet included). It normalizes with LayerNorm, not the
sequential stack's masked BatchNorm (running statistics do not compose
with microbatching), so `pipeline_stages > 1` trains another model than
`pipeline_stages: 1`; the config acknowledges it with
`Training.pipeline_norm: "layernorm"` (`require_pipeline_norm_optin`).
LayerNorm is Flax's: epsilon 1e-6, the variance max(0, E[x²] - E[x]²),
reduced in float32, written out as plain ops (`LayerNorm`).

A batch is the loader's stacked [M, ...] shards, used as M microbatches.
`make_pipeline_forward` runs the conv stack through
`pipeline.make_pipeline_apply`'s tick schedule (`pipelined=True`) or layer
after layer (`pipelined=False`: the eval path and the oracle, the same
ops on each microbatch, so the two are bitwise equal). The embed and the
heads run on stage 0's device; each microbatch's structure (its batch and
the conv's per-batch arguments, `PIPELINE_CONV_CARGS`: the kernels'
layouts, and for SchNet the edge lengths from the positions, once a
microbatch) is built on each stage's device once a forward.

Train steps (`make_pipeline_train_step`, `make_pipeline_ef_train_step`):

* ``gpipe`` differentiates all M microbatches at once;
* ``1f1b`` runs windows of W = min(S, M) microbatches, each window's
  forward and backward finished before the next window starts, with a
  float32 gradient sum across windows: at most S microbatches in flight.

`pipeline_data_shards` D > 1 (the pipe x data mesh) runs D pipe rings on
the same stage devices, each with stage streams of its own: the stacked
batch holds D x M microbatches in [d * M + m] order (JAX
`pipeline_trainer.py:359-390`), ring d runs its M, a 1f1b window holds W
microbatches of every ring, the losses and metrics reduce over the flat
[D M] axis in that order, and the gradients add over the rings in the one
autograd graph. `Optimizer.use_zero_redundancy` (JAX's sharding of the
optimizer state over the data axis) leaves the update replicated: the
rings share one device, whose memory a split would not divide
(`composite`'s docstring).

Both seed the backward with sum(losses) / M (a divide, as JAX spells it),
so their gradients differ only by the window-boundary sums (bitwise on
exactly representable data); metrics reduce the flat [M] order. Then the
non-finite watchdog, `freeze_conv_layers` on the gradients and on the
updates, the optimizer. Energy-force training takes forces = -dE/dpos
through the stages with `create_graph=True`; the "auto" force weight is
resolved over the whole batch before any windowing. The eval steps run
the sequential forward and weight each microbatch's metrics by its real
graphs. On the card a train or eval step is one CUDA graph
(train/step_graphs.py); the stage streams fork from the capture stream
and join back to it.

Mixed precision (Architecture.dtype bf16): the forward casts the
parameters and the batch's floats to bf16, as the JAX package does; the
LayerNorm widens to float32 and the block's output is cast back to the
carried activation's dtype; outputs are float32 before the losses.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..config.config import ModelConfig
from ..datasets.loader import unstack_batch
from ..graphs.batch import GraphBatch
from ..models.base import aggregation_layouts
from ..models.convs import GINConv, PNAConv, SAGEConv
from ..models.create import _lecun_normal
from ..models.layers import MLP, Dense
from ..models.schnet import CFConv
from ..models.stacks import PNAStack
from ..ops.activations import activation_function_selection, masked_loss
from ..ops.geometry import edge_vectors
from ..ops.scalars import rsqrt, weak
from ..ops.segment import global_mean_pool, global_sum_pool
from ..kernels.fused_mp import filter_layouts, segment_layouts
from ..train.loss import auto_force_weight, multihead_loss
from ..train.train_step import (EvalStep, TrainStep, _resolve_compute_dtype,
                                cast_floats)
from .mesh import ZERO_MIN_SHARD_SIZE
from .pipeline import (PIPELINE_SCHEDULES, check_stage_divisibility,
                       join_stage_streams, make_pipeline_apply, stage_device)

_log = logging.getLogger("hydragnn_tpu_torch")

PIPELINE_CONV_TYPES = {
    "GIN": lambda hidden, cfg: GINConv(hidden, hidden),
    "SAGE": lambda hidden, cfg: SAGEConv(hidden, hidden),
    "PNA": lambda hidden, cfg: PNAConv(hidden, hidden, deg_hist=cfg.pna_deg),
    "SchNet": lambda hidden, cfg: CFConv(
        hidden, hidden, num_filters=int(cfg.num_filters or 128),
        num_gaussians=int(cfg.num_gaussians or 50),
        cutoff=float(cfg.radius or 1.0),
        equivariant=bool(getattr(cfg, "equivariance", False))),
}


def _gather_cargs(batch: GraphBatch) -> Dict:
    # the sum of neighbours' rows: the dense table's slots by neighbour
    return aggregation_layouts(batch, nbr_slots=True)


def _pna_cargs(batch: GraphBatch) -> Dict:
    # the fused kernels' views, without edge features (the pipelined PNA
    # has no edge encoder)
    return PNAStack.conv_args(None, batch)


def _schnet_cargs(batch: GraphBatch) -> Dict:
    """The edge lengths from the microbatch's positions, once a
    microbatch (the JAX package stashes them in edge_attr once a forward;
    pipelined SchNet ignores the dataset's edge_attr), and on the edge
    list the filter-scatter's layouts, shared by every layer."""
    layouts = None
    if batch.nbr is None:
        layouts = filter_layouts(batch.senders, batch.receivers,
                                 batch.edge_mask, batch.num_nodes)
    by_recv, by_send = segment_layouts(layouts)
    _, length = edge_vectors(batch.pos, batch.senders, batch.receivers,
                             batch.edge_shifts, send_layout=by_send,
                             recv_layout=by_recv)
    return {"edge_length": length, "filter_layout": layouts,
            "segment_layout": (by_recv, by_send)}


# what each conv kind reads besides the batch, built once a microbatch on
# each stage's device (BaseStack.conv_args on the sequential path)
PIPELINE_CONV_CARGS = {"GIN": _gather_cargs, "SAGE": _gather_cargs,
                       "PNA": _pna_cargs, "SchNet": _schnet_cargs}


class LayerNorm(nn.Module):
    """Flax's `nn.LayerNorm` (epsilon 1e-6, `use_fast_variance`): the
    mean and max(0, E[x²] - E[x]²) over the last axis in at least
    float32, y = (x - mean) * (rsqrt(var + eps) * scale) + bias, in the
    promoted dtype of x, scale and bias."""

    def __init__(self, features: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        stat = torch.promote_types(x.dtype, torch.float32)
        xs = x.to(stat)
        mean = xs.mean(-1, keepdim=True)
        mean2 = (xs * xs).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = rsqrt(var + weak(self.epsilon, var)) * self.scale
        y = (x - mean) * mul + self.bias
        out = torch.promote_types(torch.promote_types(
            x.dtype, self.scale.dtype), self.bias.dtype)
        return y.to(out)


class PipelineBlock(nn.Module):
    """One pipelined layer: conv, LayerNorm, the activation (JAX
    `_ConvBlock`). With `carry_pos` (equivariant SchNet) the carried
    activation is [N, F + 3], the conv's updated coordinates in the last
    3 channels; the filter's edge lengths come from the microbatch's own
    positions, as on the sequential stack."""

    def __init__(self, conv: nn.Module, hidden: int, activation: str,
                 carry_pos: bool = False):
        super().__init__()
        self.conv = conv
        self.LayerNorm_0 = LayerNorm(hidden)
        self.act = activation_function_selection(activation)
        self.carry_pos = carry_pos

    def forward(self, h, batch: GraphBatch, cargs: Dict):
        if self.carry_pos:
            h, pos = h[..., :-3], h[..., -3:]
            h2, pos2 = self.conv(h, pos, batch, cargs)
            h2 = self.act(self.LayerNorm_0(h2))
            return torch.cat([h2, pos2.to(h2.dtype)], dim=-1)
        h2, _ = self.conv(h, batch.pos, batch, cargs)
        return self.act(self.LayerNorm_0(h2))


def carries_pos(cfg: ModelConfig) -> bool:
    return bool(getattr(cfg, "equivariance", False)) \
        and cfg.model_type == "SchNet"


class PipelineModel(nn.Module):
    """The pipelined stack: `embed`, `convs` (L blocks, block i on its
    stage's device) and `heads` (`head_{ih}` MLPs), under the names of the
    JAX package's parameter tree {"embed", "convs", "heads"}
    (utils/weights.py stacks and unstacks the [L] axis)."""

    def __init__(self, cfg: ModelConfig, stage_devices: Sequence):
        super().__init__()
        self.cfg = cfg
        self.stage_devices = [stage_device(d) for d in stage_devices]
        self.num_stages = len(self.stage_devices)
        self.per_stage = check_stage_divisibility(cfg.num_conv_layers,
                                                  self.num_stages)
        hidden = cfg.hidden_dim
        conv_fn = PIPELINE_CONV_TYPES[cfg.model_type]
        self.carry_pos = carries_pos(cfg)
        self.act = activation_function_selection(cfg.activation)
        self.embed = Dense(cfg.input_dim, hidden)
        self.convs = nn.ModuleList(
            PipelineBlock(conv_fn(hidden, cfg), hidden, cfg.activation,
                          self.carry_pos)
            for _ in range(cfg.num_conv_layers))
        widen = 1 + cfg.var_output
        self.heads = nn.ModuleDict({
            f"head_{ih}": MLP(hidden, list(head.dim_headlayers)
                              + [head.output_dim * widen],
                              activation=self.act)
            for ih, head in enumerate(cfg.heads)})

    def place(self) -> "PipelineModel":
        """Move the embed and heads to stage 0's device and each block to
        its stage's."""
        self.embed.to(self.stage_devices[0])
        self.heads.to(self.stage_devices[0])
        for i, block in enumerate(self.convs):
            block.to(self.stage_devices[i // self.per_stage])
        return self

    def stage_layers(self) -> List[List[nn.Module]]:
        p = self.per_stage
        return [list(self.convs[s * p:(s + 1) * p])
                for s in range(self.num_stages)]

    def structure(self, micros: List[GraphBatch]):
        """structure[s][m] = (microbatch m on stage s's device, its conv
        arguments there), built once a device."""
        cargs_fn = PIPELINE_CONV_CARGS[self.cfg.model_type]
        by_device = {}
        for dev in self.stage_devices:
            if dev not in by_device:
                on = [mb if mb.x.device == dev else mb.to(dev)
                      for mb in micros]
                by_device[dev] = [(mb, cargs_fn(mb)) for mb in on]
        return [by_device[d] for d in self.stage_devices]

    def decode(self, x, batch: GraphBatch):
        """Graph-mean-pool + per-head MLPs (JAX `_decode`)."""
        cfg = self.cfg
        x_graph = global_mean_pool(x, batch.node_graph, batch.num_graphs,
                                   batch.node_mask)
        outputs, outputs_var = [], []
        for ih, head in enumerate(cfg.heads):
            src = x_graph if head.head_type == "graph" else x
            out = self.heads[f"head_{ih}"](src)
            outputs.append(out[..., :head.output_dim])
            if cfg.var_output:
                outputs_var.append(out[..., head.output_dim:] ** 2)
        return outputs, (outputs_var if cfg.var_output else None)

    def forward(self, micros: List[GraphBatch], apply=None):
        """Per-microbatch (outputs, outputs_var): through `apply`
        (`make_pipeline_apply`'s) when given, else layer after layer."""
        dev0 = self.stage_devices[0]
        structure = self.structure(micros)
        x = [self.embed(mb.x) for mb in micros]
        if self.carry_pos:
            x = [torch.cat([xi, mb.pos.to(xi.dtype)], dim=-1)
                 for xi, mb in zip(x, micros)]
        if apply is not None:
            y = apply(self.stage_layers(), x, structure)
        else:
            y = []
            for m, h in enumerate(x):
                for i, block in enumerate(self.convs):
                    s = i // self.per_stage
                    dev = self.stage_devices[s]
                    if h.device != dev:
                        h = h.to(dev)
                    h = _layer(block, h, structure[s][m])
                y.append(h)
        out = []
        for m, h in enumerate(y):
            if h.device != dev0:
                h = h.to(dev0)
            if self.carry_pos:
                h = h[..., :-3]   # the heads read features only
            out.append(self.decode(h, micros[m]))
        return out


def _layer(block, h, structure_t):
    """One block on (batch, cargs); its output in the carried dtype
    (the LayerNorm widens to float32 under bf16)."""
    batch, cargs = structure_t
    return block(h, batch, cargs).to(h.dtype)


def init_pipeline_model(model: PipelineModel, seed: int = 0
                        ) -> PipelineModel:
    """Flax's default initializers from a seeded generator (counterpart:
    `init_pipeline_params`): Dense kernels lecun_normal, zero biases,
    LayerNorm scale 1 and bias 0, GIN's eps 100. The numbers differ from
    Flax's for the same seed; weights that must match the JAX package are
    carried across with utils/weights.py."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(_lecun_normal(mod.weight.shape,
                                               mod.in_features, gen))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, GINConv):
                mod.eps.fill_(100.0)
    return model


def create_pipeline_model(cfg: ModelConfig, stage_devices: Sequence,
                          seed: int = 0) -> PipelineModel:
    """Build, initialize and place the pipelined model."""
    return init_pipeline_model(PipelineModel(cfg, stage_devices),
                               seed).place()


def make_pipeline_forward(model: PipelineModel, pipelined: bool = True,
                          compute_dtype=None, remat: bool = False,
                          remat_policy: Optional[str] = None,
                          stage_streams: bool = True,
                          data_shards: int = 1) -> Callable:
    """forward(micros) -> per-microbatch (outputs, outputs_var), float32
    whatever the compute dtype. `pipelined=False` runs the same ops layer
    after layer (the eval path and the oracle). `compute_dtype`
    (train/precision.py) casts the parameters and the microbatches'
    floats; `remat` / `remat_policy` checkpoint each tick's stage compute;
    `stage_streams=False` keeps the ticks on the caller's stream.

    With `data_shards` D > 1 (the pipe x data mesh) the microbatches split
    into D contiguous groups, group d run through pipe ring d: the same
    stage devices and parameters, its own stage streams (stage s of ring
    d on `stage_stream(device, d * S + s)`), so the rings overlap on a
    card as far as their data lets them; the outputs come back in the
    microbatches' order."""
    cfg = model.cfg
    cdtype = _resolve_compute_dtype(cfg, compute_dtype)
    S = model.num_stages
    D = int(data_shards) if pipelined else 1
    applies = [None]
    if pipelined:
        applies = [make_pipeline_apply(model.stage_devices, _layer,
                                       cfg.num_conv_layers, remat=remat,
                                       remat_policy=remat_policy,
                                       stage_streams=stage_streams,
                                       stream_base=d * S)
                   for d in range(D)]

    def run(micros, apply):
        if cdtype == torch.float32:
            return model(micros, apply)
        variables = {n: p.to(cdtype) for n, p in model.named_parameters()}
        outs = torch.func.functional_call(
            model, variables,
            ([cast_floats(mb, cdtype) for mb in micros], apply))
        return [([o.float() for o in outputs],
                 None if ovar is None else [o.float() for o in ovar])
                for outputs, ovar in outs]

    def forward(micros: List[GraphBatch]):
        if len(applies) == 1:
            return run(micros, applies[0])
        if len(micros) % D:
            raise ValueError(f"{len(micros)} microbatches do not split over "
                             f"{D} pipe rings")
        k = len(micros) // D
        out = []
        for d, apply in enumerate(applies):
            out += run(micros[d * k:(d + 1) * k], apply)
        return out

    # the devices whose stage streams the forward forks, in stream-key
    # order (none off the card, none on one stream): a backward through
    # it joins them back
    forward.stream_devices = (
        list(model.stage_devices) * D if pipelined and stage_streams
        and model.stage_devices[0].type == "cuda" else [])
    return forward


def pipeline_window_size(num_stages: int, microbatches: int) -> int:
    """1F1B window: min(S, M) microbatches in flight at once."""
    return min(int(num_stages), int(microbatches))


def _window_check(M: int, W: int) -> None:
    if M % W:
        raise ValueError(
            f"the 1f1b schedule windows {M} microbatches into groups of "
            f"{W} (= min(stages, microbatches)): set microbatches to a "
            f"multiple of the stage count (or at most the stage count), "
            f"or use schedule=\"gpipe\"")


def _freeze(cfg: ModelConfig, names, tensors):
    """freeze_conv_layers on the pipelined model: the `convs` blocks'
    gradients and updates are zero (embed and heads train)."""
    if not getattr(cfg, "freeze_conv", False) or tensors is None:
        return tensors
    return [torch.zeros_like(t) if n.startswith("convs.") else t
            for n, t in zip(names, tensors)]


def _watchdog(loss: torch.Tensor, grads) -> torch.Tensor:
    """1.0 when the loss or any gradient holds a non-finite value, else
    0.0: one concatenation and check a device, on the loss's device."""
    by_dev: Dict[torch.device, list] = {}
    for g in grads:
        by_dev.setdefault(g.device, []).append(g.reshape(-1).float())
    bad = ~torch.isfinite(loss.detach().float()).all()
    for gs in by_dev.values():
        flag = ~torch.isfinite(torch.cat(gs)).all()
        bad = bad | flag.to(loss.device)
    return bad.float()


def _grads(total, params):
    grads = torch.autograd.grad(total, params, allow_unused=True,
                                materialize_grads=True)
    return list(grads)


def _schedule_grads(micro_fn, params, micros, schedule: str,
                    num_stages: int, stream_devices, data_shards: int = 1):
    """(gradients, per-microbatch value rows): gpipe one backward of
    sum(losses) / DM over all D x M microbatches; 1f1b one a window, each
    seeded with sum(window losses) / DM and summed in float32 into zeros
    (JAX `_windowed_grads`). With D data shards (pipe rings) the flat
    microbatch order is [d * M + m], and window w holds microbatches
    [w W, (w + 1) W) of every ring, W = min(S, M) (the rings advance in
    lockstep); the rows come back in the flat order. `micro_fn(window) ->
    list of per-microbatch tuples whose first entry is the loss`.
    `stream_devices` are the forward's (`make_pipeline_forward`), whose
    stage streams each backward joins back to the caller's stream."""
    DM = len(micros)
    D = int(data_shards)
    M = DM // D
    if schedule == "1f1b":
        W = pipeline_window_size(num_stages, M)
        _window_check(M, W)
        gsum = [torch.zeros_like(p) for p in params]
        rows: List = [None] * DM
        for w in range(M // W):
            at = [d * M + w * W + j for d in range(D) for j in range(W)]
            vals = micro_fn([micros[i] for i in at])
            total = torch.sum(torch.stack([v[0] for v in vals])) / DM
            g = _grads(total, params)
            join_stage_streams(stream_devices)
            torch._foreach_add_(gsum, g)
            for i, v in zip(at, vals):
                rows[i] = tuple(t.detach() for t in v)
        return gsum, rows
    vals = micro_fn(micros)
    total = torch.sum(torch.stack([v[0] for v in vals])) / DM
    g = _grads(total, params)
    join_stage_streams(stream_devices)
    return g, [tuple(t.detach() for t in v) for v in vals]


def _update(state, cfg: ModelConfig, tx, grads, scalars):
    """freeze, the optimizer's update, freeze, apply: in place."""
    names = list(state.params)
    params = list(state.params.values())
    grads = _freeze(cfg, names, grads)
    updates, state.opt_state = tx.update(grads, state.opt_state, params,
                                         scalars)
    updates = _freeze(cfg, names, updates)
    if updates is not None:
        with torch.no_grad():
            torch._foreach_add_(params, updates)
    state.step += 1


def _task_rows(cfg, loss_name, forward, micros):
    """Per microbatch (loss, task_0, ...) of the multihead loss."""
    rows = []
    for (outs, ovar), mb in zip(forward(micros), micros):
        total, tasks = multihead_loss(cfg, loss_name, outs, ovar, mb)
        rows.append((total, *tasks))
    return rows


def _check_schedule(schedule: str) -> None:
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r} "
                         f"(use one of {PIPELINE_SCHEDULES})")


class PipelineTrainStep(TrainStep):
    """step(state, stacked batch) -> (state, metrics): one pipelined
    optimizer step in place (train_step.TrainStep: a CUDA graph on the
    card); eager when the stages span several devices, since a CUDA
    graph holds one card's work."""

    def __init__(self, model, body: Callable, tx):
        super().__init__(model, body, tx)
        self.graphs = len(set(model.stage_devices)) == 1

    def __call__(self, state, batch: GraphBatch):
        if self.graphs:
            return super().__call__(state, batch)
        return self.eager(state, batch)


class PipelineEvalStep(EvalStep):
    """eval_step(state, batch) -> (metrics, None) with the sequential
    forward (train_step.EvalStep); eager when the stages span several
    devices."""

    def __init__(self, model, body: Callable):
        super().__init__(model, body)
        self.graphs = len(set(model.stage_devices)) == 1

    def __call__(self, state, batch: GraphBatch):
        if self.graphs:
            return super().__call__(state, batch)
        return self.eager(state, batch)


def make_pipeline_train_step(model: PipelineModel, tx,
                             loss_name: str = "mse",
                             schedule: str = "1f1b", remat: bool = False,
                             remat_policy=None, pipelined: bool = True,
                             compute_dtype=None, stage_streams: bool = True,
                             data_shards: int = 1, zero_opt: bool = False,
                             zero_min_size: int = ZERO_MIN_SHARD_SIZE
                             ) -> PipelineTrainStep:
    """The pipelined train step (JAX `make_pipeline_train_step`); metrics
    loss, task_i and nonfinite_steps. The stacked batch holds D x M
    microbatches ([d * M + m]) for `data_shards` D pipe rings, whose
    gradients add; `zero_opt` and `zero_min_size` are JAX's ZeRO knobs,
    the update replicated (the module's docstring)."""
    _check_schedule(schedule)
    cfg = model.cfg
    forward = make_pipeline_forward(model, pipelined=pipelined,
                                    compute_dtype=compute_dtype, remat=remat,
                                    remat_policy=remat_policy,
                                    stage_streams=stage_streams,
                                    data_shards=data_shards)

    def micro_fn(micros):
        return _task_rows(cfg, loss_name, forward, micros)

    def body(state, batch: GraphBatch, scalars=None):
        micros = unstack_batch(batch)
        params = list(state.params.values())
        grads, rows = _schedule_grads(micro_fn, params, micros, schedule,
                                      model.num_stages,
                                      forward.stream_devices, data_shards)
        losses = torch.stack([r[0] for r in rows])
        metrics = {"loss": torch.mean(losses)}
        for i in range(len(cfg.heads)):
            metrics[f"task_{i}"] = torch.mean(
                torch.stack([r[1 + i] for r in rows]))
        metrics["nonfinite_steps"] = _watchdog(metrics["loss"], grads)
        _update(state, cfg, tx, grads, scalars)
        return metrics, None

    return PipelineTrainStep(model, body, tx)


def resolve_ef_force_weight(micros: List[GraphBatch], energy_weight,
                            force_weight):
    """One force weight for the whole batch (JAX
    `_resolve_ef_force_weight`): "auto" is resolved over every
    microbatch's labels at once, before any windowing."""
    if force_weight != "auto":
        return force_weight
    return auto_force_weight(torch.cat([mb.energy for mb in micros]),
                             torch.cat([mb.forces for mb in micros]),
                             torch.cat([mb.graph_mask for mb in micros]),
                             torch.cat([mb.node_mask for mb in micros]),
                             energy_weight)


def ef_rows(cfg: ModelConfig, loss_name, forward, micros: List[GraphBatch],
            energy_weight, force_weight, create_graph: bool = True):
    """Per microbatch (total, energy loss, force loss): graph energy the
    masked sum of head 0's node energies, forces = -dE/dpos through the
    forward (JAX `_ef_losses`). `force_weight` may be "auto" (resolved
    over these microbatches) or a resolved value."""
    with torch.enable_grad():
        pos = [mb.pos.detach().requires_grad_(True) for mb in micros]
        st = [mb.replace(pos=p) for mb, p in zip(micros, pos)]
        graph_e = []
        tot = 0.0
        for (outs, _), mb in zip(forward(st), st):
            ge = global_sum_pool(outs[0][..., :1], mb.node_graph,
                                 mb.num_graphs, mb.node_mask)
            graph_e.append(ge)
            tot = tot + torch.sum(torch.where(mb.graph_mask[:, None], ge,
                                              torch.zeros_like(ge)))
        # on the calling thread: autograd orders ready nodes by a
        # per-thread sequence number, so double-backward nodes made on
        # the card's autograd thread would rank against the forward's by
        # each thread's history, and a parameter's several gradient
        # contributions would add in a history-dependent order
        with torch.autograd.set_multithreading_enabled(False):
            grads = torch.autograd.grad(tot, pos, create_graph=create_graph,
                                        allow_unused=True,
                                        materialize_grads=True)
        join_stage_streams(forward.stream_devices)
    fw = resolve_ef_force_weight(micros, energy_weight, force_weight)
    rows = []
    for ge, g, mb in zip(graph_e, grads, micros):
        if not create_graph:
            ge, g = ge.detach(), g.detach()
        e_loss = masked_loss(loss_name, ge, mb.energy, mb.graph_mask)
        f_loss = masked_loss(loss_name, -g, mb.forces, mb.node_mask)
        rows.append((energy_weight * e_loss + fw * f_loss, e_loss, f_loss))
    return rows


def make_pipeline_ef_train_step(model: PipelineModel, tx,
                                loss_name: str = "mse",
                                energy_weight: float = 1.0,
                                force_weight=1.0, schedule: str = "1f1b",
                                remat: bool = False, remat_policy=None,
                                compute_dtype=None,
                                stage_streams: bool = True,
                                data_shards: int = 1, zero_opt: bool = False,
                                zero_min_size: int = ZERO_MIN_SHARD_SIZE
                                ) -> PipelineTrainStep:
    """Energy-force training through the stages (JAX
    `make_pipeline_ef_train_step`): the parameter gradient is a second
    derivative through the schedule, the 1f1b windows and remat
    included; metrics loss, energy_loss, force_loss, nonfinite_steps.

    Remat "dots" recomputes every op here, as "full" does: torch's
    selective checkpointing allows one backward through a region, and
    the parameter gradient passes the stages twice (once for the
    forces, once for the energy). The values and gradients are those of
    any remat setting, bit for bit; only the memory and recompute
    differ from JAX's `checkpoint_dots`."""
    _check_schedule(schedule)
    cfg = model.cfg
    if remat and remat_policy == "dots":
        _log.info("pipeline remat 'dots' under energy-force training "
                  "recomputes every op ('full'): selective checkpointing "
                  "allows one backward through a region")
        remat_policy = "full"
    forward = make_pipeline_forward(model, pipelined=True,
                                    compute_dtype=compute_dtype, remat=remat,
                                    remat_policy=remat_policy,
                                    stage_streams=stage_streams,
                                    data_shards=data_shards)

    def body(state, batch: GraphBatch, scalars=None):
        micros = unstack_batch(batch)
        params = list(state.params.values())
        # a whole-batch statistic: resolved before any windowing
        fw = resolve_ef_force_weight(micros, energy_weight, force_weight)

        def micro_fn(window):
            return ef_rows(cfg, loss_name, forward, window, energy_weight,
                           fw)
        grads, rows = _schedule_grads(micro_fn, params, micros, schedule,
                                      model.num_stages,
                                      forward.stream_devices, data_shards)
        metrics = {k: torch.mean(torch.stack([r[i] for r in rows]))
                   for i, k in enumerate(("loss", "energy_loss",
                                          "force_loss"))}
        metrics["nonfinite_steps"] = _watchdog(metrics["loss"], grads)
        _update(state, cfg, tx, grads, scalars)
        return metrics, None

    return PipelineTrainStep(model, body, tx)


def _weighted(rows, micros, keys) -> Dict[str, torch.Tensor]:
    """Metrics weighted by each microbatch's real graphs (JAX
    `make_pipeline_eval_step`)."""
    w = torch.stack([mb.graph_mask.float().sum() for mb in micros])
    wsum = torch.clamp(torch.sum(w), min=1.0)
    return {k: torch.sum(torch.stack([r[i] for r in rows]) * w) / wsum
            for i, k in enumerate(keys)}


def make_pipeline_eval_step(model: PipelineModel, loss_name: str = "mse"
                            ) -> PipelineEvalStep:
    """Sequential-forward eval over the stacked microbatches."""
    cfg = model.cfg
    forward = make_pipeline_forward(model, pipelined=False)
    keys = ["loss"] + [f"task_{i}" for i in range(len(cfg.heads))]

    def body(state, batch: GraphBatch, scalars=None):
        micros = unstack_batch(batch)
        with torch.no_grad():
            rows = _task_rows(cfg, loss_name, forward, micros)
            return _weighted(rows, micros, keys), None

    return PipelineEvalStep(model, body)


def make_pipeline_ef_eval_step(model: PipelineModel, loss_name: str = "mse",
                               energy_weight: float = 1.0, force_weight=1.0
                               ) -> PipelineEvalStep:
    """Sequential-forward energy-force eval (forces without a graph to
    the weights)."""
    cfg = model.cfg
    forward = make_pipeline_forward(model, pipelined=False)

    def body(state, batch: GraphBatch, scalars=None):
        micros = unstack_batch(batch)
        rows = ef_rows(cfg, loss_name, forward, micros, energy_weight,
                       force_weight, create_graph=False)
        rows = [tuple(t.detach() for t in r) for r in rows]
        return _weighted(rows, micros,
                         ("loss", "energy_loss", "force_loss")), None

    return PipelineEvalStep(model, body)


def validate_pipeline_config(cfg: ModelConfig, num_stages: int,
                             batch_size: int, microbatches: int,
                             schedule: str = "1f1b",
                             data_shards: int = 1,
                             device_count: int = 0) -> None:
    """The JAX package's config checks, with its messages; the device
    count is the stage devices'."""
    if cfg.model_type not in PIPELINE_CONV_TYPES:
        raise ValueError(
            f"Training.pipeline_stages supports model_type in "
            f"{sorted(PIPELINE_CONV_TYPES)} (homogeneous conv stacks); "
            f"got {cfg.model_type}")
    check_stage_divisibility(cfg.num_conv_layers, num_stages)
    data_shards = int(data_shards or 1)
    if data_shards < 1:
        raise ValueError(
            f"pipeline_data_shards must be >= 1 (got {data_shards})")
    if device_count < num_stages * data_shards:
        raise ValueError(
            f"pipeline_stages={num_stages} x pipeline_data_shards="
            f"{data_shards} exceeds device count {device_count}")
    if microbatches < 2:
        raise ValueError(
            f"pipeline_microbatches must be >= 2 (got {microbatches})")
    if batch_size % (microbatches * data_shards):
        raise ValueError(
            f"batch_size={batch_size} does not split into "
            f"{microbatches} microbatches x {data_shards} data shards")
    if schedule not in PIPELINE_SCHEDULES:
        raise ValueError(
            f"pipeline_schedule must be one of {PIPELINE_SCHEDULES} "
            f"(got {schedule!r})")
    if schedule == "1f1b" and microbatches > num_stages \
            and microbatches % num_stages:
        raise ValueError(
            f"the 1f1b schedule windows {microbatches} microbatches into "
            f"groups of pipeline_stages={num_stages}: set "
            f"pipeline_microbatches to a multiple of pipeline_stages (or "
            f"at most pipeline_stages), or use pipeline_schedule "
            f"\"gpipe\"")
    for head in cfg.heads:
        if head.head_type != "graph" and head.node_arch not in ("mlp",):
            raise ValueError(
                "pipelined path supports graph heads and mlp node heads")
    if getattr(cfg, "equivariance", False) and not carries_pos(cfg):
        raise ValueError(
            "Training.pipeline_stages supports Architecture.equivariance "
            "only for SchNet (coordinate updates ride the carried "
            "activation); train other equivariant models on the "
            "sequential path")


def require_pipeline_norm_optin(train_cfg: dict) -> None:
    """`pipeline_stages > 1` trains the LayerNorm stack, another
    architecture than the sequential one: the config must say
    `Training.pipeline_norm: "layernorm"`."""
    norm = train_cfg.get("pipeline_norm")
    if norm != "layernorm":
        raise ValueError(
            "Training.pipeline_stages > 1 trains the pipelined LayerNorm "
            "stack — a DIFFERENT architecture from pipeline_stages=1 "
            "(MaskedBatchNorm; running stats do not compose with GPipe "
            "microbatching), with non-interchangeable checkpoints. "
            "Acknowledge by setting Training.pipeline_norm: \"layernorm\" "
            f"(got {norm!r}).")
