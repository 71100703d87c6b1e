"""Train and eval steps (counterpart: hydragnn_tpu/train/train_step.py).

A step is one eager forward, `torch.autograd.grad` of the loss with
respect to the model's parameters, the optimizer's update and its
addition to the parameters — what the JAX package jits into one program.
The model holds its parameters and buffers; a `TrainState` names them
(the same tensors) beside the optimizer state and the step count, so a
state can be snapshot (`copy`) and put back (`restore`).

`make_train_step` puts the model in training mode (BatchNorm on batch
statistics, running statistics updated once per step); `make_eval_step`
in eval mode. `make_multi_train_step` / `make_multi_eval_step` run S
steps on S batches in one call (the JAX package's `lax.scan` of the
step). `make_sampled_train_step` / `make_sampled_eval_step` are the steps
of sampled training on one giant graph (preprocess/sampling.py): the
seed-masked loss and, at staleness K > 0, the historical-embedding
tables read and refreshed in place inside the step. On the card each step, and each group of S, is one CUDA graph
replay (train/step_graphs.py); on the CPU the same calls run the eager
steps, which are also the graphs' capture bodies. The energy-force path
(`compute_grad_energy`) takes the forces with `create_graph=True` in
training and without it in evaluation, which still needs gradients to
the positions and so runs under `torch.enable_grad()`.

Mixed precision (`compute_dtype`, resolved once by
`train/precision.resolve_precision`): the parameters stay float32
masters. Each forward (`make_forward_fn`) runs the model through
`torch.func.functional_call` on bf16 copies of its parameters and
buffers, cast with autograd, so the gradients land on the float32
masters through the casts; the batch's float fields, positions included,
are cast to bf16 (forces are -dE/dpos through that cast); the outputs
come back as float32 before any loss; in training the BatchNorm running
statistics the forward updated on its bf16 copies are written back to
the float32 buffers. This is the JAX package's casting policy
(train_step.py:99-160), not `torch.autocast`, whose per-op lists keep
norms and reductions in float32 and give other numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..config.config import ModelConfig
from ..graphs.batch import GraphBatch
from ..models.base import check_hist_encode
from .step_graphs import GraphedSteps
from .loss import energy_force_loss, multihead_loss
from .optimizer import Optimizer, OptState
from .precision import check_ported_precision, resolve_precision

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainState:
    """params / batch_stats: the model's parameters and buffers by name
    (the tensors themselves); opt_state: the optimizer's; step: updates
    taken."""
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: OptState
    step: int = 0

    @classmethod
    def create(cls, model: torch.nn.Module, tx: Optimizer,
               zero=None) -> "TrainState":
        """The model's state and a fresh optimizer state; `zero` (a
        `parallel.spmd.ZeroPartition`) keeps only this rank's rows of the
        optimizer slots it splits."""
        params = dict(model.named_parameters())
        return cls(params=params, batch_stats=dict(model.named_buffers()),
                   opt_state=tx.init(list(params.values()), zero=zero),
                   step=0)

    def copy(self) -> "TrainState":
        """A snapshot: detached clones of every tensor (keep_best holds
        one; the live state goes on changing in place)."""
        return TrainState(
            params={k: v.detach().clone() for k, v in self.params.items()},
            batch_stats={k: v.detach().clone()
                         for k, v in self.batch_stats.items()},
            opt_state=_clone_opt_state(self.opt_state), step=self.step)

    def restore(self, snapshot: "TrainState") -> "TrainState":
        """Copy a snapshot's values into this state's tensors (the
        model's parameters and buffers, the optimizer's slots and
        accumulator), in place, and its counters; returns self. The
        tensors stay this state's, so a captured step replays on the
        restored values."""
        with torch.no_grad():
            for live, snap in ((self.params, snapshot.params),
                               (self.batch_stats, snapshot.batch_stats)):
                for k, v in live.items():
                    v.copy_(snap[k])
            opt, snap_opt = self.opt_state, snapshot.opt_state
            for k, ts in opt.slots.items():
                for v, w in zip(ts, snap_opt.slots[k]):
                    v.copy_(w)
            for v, w in zip(opt.acc_grads or (), snap_opt.acc_grads or ()):
                v.copy_(w)
        return self.restore_host(snapshot)

    def restore_host(self, snapshot: "TrainState") -> "TrainState":
        """Put back only the host's counters: the step, the learning rate
        and the optimizer's count, mini_step and gradient_step."""
        opt, snap_opt = self.opt_state, snapshot.opt_state
        opt.learning_rate = snap_opt.learning_rate
        opt.count = snap_opt.count
        opt.mini_step = snap_opt.mini_step
        opt.gradient_step = snap_opt.gradient_step
        self.step = snapshot.step
        return self

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Parameters and buffers under the model's state-dict names."""
        return {**self.params, **self.batch_stats}


def _clone_opt_state(opt: OptState) -> OptState:
    def clone(ts):
        return None if ts is None else [t.detach().clone() for t in ts]
    return dataclasses.replace(
        opt, slots={k: clone(v) for k, v in opt.slots.items()},
        acc_grads=clone(opt.acc_grads))


def _is_encoder(name: str, num_conv: int) -> bool:
    """conv_0..conv_{L-1} and feature_norm_*: the stack
    `freeze_conv_layers` freezes (node-head convs, numbered from L + 100,
    stay trainable)."""
    key = name.split(".", 1)[0]
    if key.startswith("feature_norm_"):
        return True
    if key.startswith("conv_"):
        try:
            return int(key.split("_")[-1]) < num_conv
        except ValueError:
            return False
    return False


def freeze_conv_grads(names, tensors, cfg: ModelConfig):
    """Zero the gradients (or the optimizer's updates) of the conv stack
    and its feature norms when `freeze_conv_layers` is set; applied to
    both, since AdamW's decoupled weight decay moves a parameter with a
    zero gradient."""
    if not getattr(cfg, "freeze_conv", False) or tensors is None:
        return tensors
    num = int(cfg.num_conv_layers)
    return [torch.zeros_like(t) if _is_encoder(n, num) else t
            for n, t in zip(names, tensors)]


def _nonfinite_watchdog(loss, grads) -> torch.Tensor:
    """1.0 when the loss or any gradient holds a non-finite value, else
    0.0 (one concatenation and one check on the card)."""
    flat = torch.cat([loss.detach().reshape(1).float()]
                     + [g.reshape(-1).float() for g in grads])
    return (~torch.isfinite(flat).all()).float()


def _resolve_compute_dtype(cfg: ModelConfig, compute_dtype=None
                           ) -> torch.dtype:
    """The step's compute dtype: `compute_dtype`, HYDRAGNN_PRECISION,
    Architecture.dtype, float32 (train/precision.py). int8 raises: it is
    a serving-only precision."""
    name = resolve_precision(getattr(cfg, "dtype", None), compute_dtype)
    if name == "int8":
        raise ValueError(
            "int8 is a serving-only precision (post-training "
            "quantization): casting float parameters and activations to "
            "int8 in a train or eval step would destroy them; train in "
            "float32 or bfloat16")
    return _DTYPES[check_ported_precision(name)]


def cast_floats(batch: GraphBatch, dtype: torch.dtype) -> GraphBatch:
    """The batch with every floating-point field cast to `dtype`; ids
    and masks untouched."""
    return batch.replace(**{
        f.name: getattr(batch, f.name).to(dtype)
        for f in dataclasses.fields(batch)
        if getattr(batch, f.name) is not None
        and getattr(batch, f.name).is_floating_point()})


def _cast_variables(model, dtype) -> Dict[str, torch.Tensor]:
    """The model's parameters and buffers cast to `dtype` (the parameter
    casts are recorded by autograd)."""
    return {name: t.to(dtype) for name, t in
            list(model.named_parameters()) + list(model.named_buffers())}


def _to_f32(outputs):
    return None if outputs is None else [o.float() for o in outputs]


def make_forward_fn(model, cfg: ModelConfig = None, compute_dtype=None,
                    frozen: bool = False) -> Callable:
    """forward(batch) -> (outputs, outputs_var) with the mixed-precision
    casting policy: float32 batch and parameters in, float32 outputs out,
    the model computing in the resolved compute dtype (the model itself
    at float32). In training mode the BatchNorm running statistics the
    bf16 forward updates are written back to the model's float32
    buffers. `frozen` casts the weights once, here, for a caller whose
    weights change only by copying new values into the same tensors (the
    serving engine's hot swap), which then re-casts them into the same
    buffers, `forward.frozen_variables`."""
    cdtype = _resolve_compute_dtype(cfg, compute_dtype)
    if cdtype == torch.float32:
        return model
    frozen_vars = _cast_variables(model, cdtype) if frozen else None

    def forward(batch: GraphBatch, **kwargs):
        variables = (frozen_vars if frozen_vars is not None
                     else _cast_variables(model, cdtype))
        outputs, outputs_var = torch.func.functional_call(
            model, variables, (cast_floats(batch, cdtype),), kwargs)
        if model.training:
            with torch.no_grad():
                for name, buf in model.named_buffers():
                    buf.copy_(variables[name])
        return _to_f32(outputs), _to_f32(outputs_var)

    forward.frozen_variables = frozen_vars
    return forward


def make_loss_fn(model, cfg: ModelConfig, loss_name: str = "mse",
                 compute_grad_energy: bool = False,
                 energy_weight: float = 1.0, force_weight=1.0,
                 compute_dtype=None):
    """loss_fn(batch) -> (total, metrics) of the model as it stands (its
    mode decides the BatchNorm statistics): the multihead loss, or on the
    energy-force path the energy + force loss with the forces' graph kept
    for a gradient with respect to the weights. The forward follows
    `make_forward_fn`'s precision policy; losses are float32."""
    forward = make_forward_fn(model, cfg, compute_dtype)

    def loss_fn(batch: GraphBatch):
        if compute_grad_energy:
            total, aux = energy_force_loss(forward, cfg, batch, loss_name,
                                           energy_weight, force_weight,
                                           create_graph=True)
            return total, {"loss": total, "energy_loss": aux["energy_loss"],
                           "force_loss": aux["force_loss"]}
        outputs, outputs_var = forward(batch)
        total, tasks = multihead_loss(cfg, loss_name, outputs, outputs_var,
                                      batch)
        return total, _task_metrics(total, tasks)

    return loss_fn


def _task_metrics(total, tasks) -> Dict[str, torch.Tensor]:
    """The multihead loss's metrics: `loss` and one `task_i` a head."""
    metrics = {"loss": total}
    for i, t in enumerate(tasks):
        metrics[f"task_{i}"] = t
    return metrics


def _train_body(model, cfg: ModelConfig, tx: Optimizer,
                loss_fn: Callable) -> Callable:
    """body(state, batch, scalars) -> (metrics, states): one eager
    optimizer step, in place, on `loss_fn(batch) -> (total, metrics)` or
    `(total, metrics, states)`; `states` (the sampled loss's encoder
    states) come back detached, else None. `scalars` is the step's row of
    the optimizer's scalars (None: made from the host's counters)."""

    def body(state: TrainState, batch: GraphBatch, scalars=None):
        model.train()
        names = list(state.params)
        params = list(state.params.values())
        total, metrics, *states = loss_fn(batch)
        # a parameter off the loss's graph (SchNet's coordinate MLP, whose
        # positions the heads never read) gets a zero gradient, as in JAX
        grads = torch.autograd.grad(total, params, allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["nonfinite_steps"] = _nonfinite_watchdog(total, grads)
        grads = freeze_conv_grads(names, list(grads), cfg)
        updates, state.opt_state = tx.update(grads, state.opt_state, params,
                                             scalars)
        updates = freeze_conv_grads(names, updates, cfg)
        if updates is not None:
            with torch.no_grad():
                torch._foreach_add_(params, updates)
        state.step += 1
        return metrics, (states[0].detach() if states else None)

    body.loss_fn = loss_fn
    return body


def step_cost_flops(step, batch: GraphBatch) -> float:
    """The FLOPs of one train step of `step` (a TrainStep or
    MultiTrainStep) on a placed `batch`: its loss's forward and the
    gradient with respect to the parameters, counted by
    `torch.utils.flop_counter.FlopCounterMode` (counterpart:
    hydragnn_tpu/train/train_step.py `step_cost_flops`, which reads XLA's
    cost analysis of the compiled step).

    This is matrix-product FLOPs only (mm, addmm, bmm and their kin),
    not XLA's count, which includes elementwise work: the optimizer
    update, activations and the aggregations add nothing. The
    hand-written kernels and their plain versions hold no counted
    product, so the count is the same on either route. The probe runs
    eagerly and leaves the run as it was: no optimizer step, the
    gradients dropped, the model's buffers (BatchNorm statistics), mode
    and the RNG put back."""
    from torch.utils.flop_counter import FlopCounterMode
    model, loss_fn = step.steps.model, step.steps.body.loss_fn
    training = model.training
    buffers = [(b, b.detach().clone()) for b in model.buffers()]
    cpu_rng = torch.get_rng_state()
    cuda_rng = (torch.cuda.get_rng_state(batch.x.device)
                if batch.x.is_cuda else None)
    params = [p for p in model.parameters() if p.requires_grad]
    try:
        model.train()
        with FlopCounterMode(display=False) as counter:
            total = loss_fn(batch)[0]
            torch.autograd.grad(total, params, allow_unused=True)
        return float(counter.get_total_flops())
    finally:
        with torch.no_grad():
            for live, saved in buffers:
                live.copy_(saved)
        model.train(training)
        torch.set_rng_state(cpu_rng)
        if cuda_rng is not None:
            torch.cuda.set_rng_state(cuda_rng, batch.x.device)
            # the restored buffers are in place before the next replay,
            # which may run on another stream
            torch.cuda.synchronize(batch.x.device)


class TrainStep:
    """step(state, batch) -> (state, metrics): one optimizer step on the
    state's parameters (the model's, float32 at every compute dtype), in
    place; metrics are detached 0-dim tensors: loss, task_i or
    energy_loss/force_loss, and nonfinite_steps (computed before the conv
    freeze). A captured graph on the card, the eager step on the CPU;
    `eager(state, batch)` runs the eager step on any device."""

    def __init__(self, model, body: Callable, tx: Optimizer):
        self.steps = GraphedSteps(model, body, tx, mode="train")

    def __call__(self, state: TrainState, batch: GraphBatch):
        stacked, per_step, _ = self.steps(state, [batch])
        return state, (per_step[0] if per_step is not None
                       else {k: v[0] for k, v in stacked.items()})

    def eager(self, state: TrainState, batch: GraphBatch):
        _, per_step, _ = self.steps.eager(state, [batch])
        return state, per_step[0]


class MultiTrainStep:
    """multi(state, batches) -> (state, metrics): S optimizer steps on S
    placed batches, metrics stacked as [S] (the JAX package's
    `make_multi_train_step`). One CUDA graph replay on the card; S eager
    steps on the CPU and in `eager`."""

    def __init__(self, model, body: Callable, tx: Optimizer):
        self.steps = GraphedSteps(model, body, tx, mode="train")

    def __call__(self, state: TrainState, batches: Sequence[GraphBatch]):
        return state, self.steps(state, list(batches))[0]

    def eager(self, state: TrainState, batches: Sequence[GraphBatch]):
        return state, self.steps.eager(state, list(batches))[0]


def make_train_step(model, cfg: ModelConfig, tx: Optimizer,
                    loss_name: str = "mse", compute_grad_energy: bool = False,
                    energy_weight: float = 1.0,
                    force_weight=1.0, compute_dtype=None) -> TrainStep:
    """The single train step (`TrainStep`)."""
    return TrainStep(model, _train_body(model, cfg, tx, make_loss_fn(
        model, cfg, loss_name, compute_grad_energy, energy_weight,
        force_weight, compute_dtype)), tx)


def make_multi_train_step(model, cfg: ModelConfig, tx: Optimizer,
                          loss_name: str = "mse",
                          compute_grad_energy: bool = False,
                          energy_weight: float = 1.0, force_weight=1.0,
                          compute_dtype=None) -> MultiTrainStep:
    """S train steps a call (`MultiTrainStep`); the same arguments as
    `make_train_step`."""
    return MultiTrainStep(model, _train_body(model, cfg, tx, make_loss_fn(
        model, cfg, loss_name, compute_grad_energy, energy_weight,
        force_weight, compute_dtype)), tx)


def eval_metrics_and_outputs(model, cfg: ModelConfig, loss_name: str,
                             batch: GraphBatch,
                             compute_grad_energy: bool = False,
                             energy_weight: float = 1.0, force_weight=1.0,
                             forward=None):
    """(metrics, outputs) of the model in eval mode on one batch; on the
    energy-force path outputs are [energies, forces]. `forward` is
    `make_forward_fn`'s (the model itself by default)."""
    model.eval()
    forward = forward or model
    if compute_grad_energy:
        total, aux = energy_force_loss(forward, cfg, batch, loss_name,
                                       energy_weight, force_weight,
                                       create_graph=False)
        metrics = {"loss": total.detach(),
                   "energy_loss": aux["energy_loss"].detach(),
                   "force_loss": aux["force_loss"].detach()}
        return metrics, [aux["energy_pred"], aux["forces_pred"]]
    with torch.no_grad():
        outputs, outputs_var = forward(batch)
        total, tasks = multihead_loss(cfg, loss_name, outputs, outputs_var,
                                      batch)
    return _task_metrics(total, tasks), outputs


def _eval_body(model, cfg: ModelConfig, loss_name: str,
               compute_grad_energy: bool, energy_weight: float, force_weight,
               compute_dtype) -> Callable:
    """body(state, batch, scalars) -> (metrics, outputs) in eval mode
    (`scalars` unused: an eval step updates nothing)."""
    forward = make_forward_fn(model, cfg, compute_dtype)

    def body(state: TrainState, batch: GraphBatch, scalars=None):
        return eval_metrics_and_outputs(model, cfg, loss_name, batch,
                                        compute_grad_energy, energy_weight,
                                        force_weight, forward)

    return body


class EvalStep:
    """eval_step(state, batch) -> (metrics, outputs) with the state's
    parameters (the model's) in eval mode: a captured graph on the card
    (its outputs cloned from the graph's), the eager step on the CPU."""

    def __init__(self, model, body: Callable):
        self.steps = GraphedSteps(model, body, mode="eval",
                                  keep_outputs=True)

    def __call__(self, state: TrainState, batch: GraphBatch):
        stacked, per_step, outputs = self.steps(state, [batch])
        return (per_step[0] if per_step is not None
                else {k: v[0] for k, v in stacked.items()}), outputs

    def eager(self, state: TrainState, batch: GraphBatch):
        _, per_step, outputs = self.steps.eager(state, [batch])
        return per_step[0], outputs


class MultiEvalStep:
    """multi_eval(state, batches) -> metrics stacked as [S] (the JAX
    package's `make_multi_eval_step`: outputs are dropped)."""

    def __init__(self, model, body: Callable):
        self.steps = GraphedSteps(model, body, mode="eval")

    def __call__(self, state: TrainState, batches: Sequence[GraphBatch]):
        return self.steps(state, list(batches))[0]


def make_eval_step(model, cfg: ModelConfig, loss_name: str = "mse",
                   compute_grad_energy: bool = False,
                   energy_weight: float = 1.0,
                   force_weight=1.0, compute_dtype=None) -> EvalStep:
    """The single eval step (`EvalStep`), in the resolved compute
    dtype."""
    return EvalStep(model, _eval_body(model, cfg, loss_name,
                                      compute_grad_energy, energy_weight,
                                      force_weight, compute_dtype))


def make_multi_eval_step(model, cfg: ModelConfig, loss_name: str = "mse",
                         compute_grad_energy: bool = False,
                         energy_weight: float = 1.0, force_weight=1.0,
                         compute_dtype=None) -> MultiEvalStep:
    """S eval steps a call, metrics only (`MultiEvalStep`)."""
    return MultiEvalStep(model, _eval_body(model, cfg, loss_name,
                                           compute_grad_energy,
                                           energy_weight, force_weight,
                                           compute_dtype))


# ------------------------------------------------- sampled giant-graph --
# (counterpart: hydragnn_tpu/train/train_step.py:209-393)
def _seed_loss_batch(batch: GraphBatch) -> GraphBatch:
    """The loss view of a sampled batch: node heads supervised on the seed
    slots only (the hop slots give the seeds their receptive field); the
    forward keeps the full node_mask."""
    if batch.seed_mask is None:
        return batch
    return batch.replace(node_mask=batch.seed_mask)


def make_sampled_loss_fn(model, cfg: ModelConfig, loss_name: str = "ce",
                         compute_dtype=None, num_hist_layers: int = 0):
    """loss_fn(batch) -> (total, metrics) of the model in its mode: the
    seed-masked multihead loss (`make_loss_fn`'s on the seed slots, the
    forward on every slot); with `num_hist_layers` > 0 -> (total,
    metrics, states), the encoder's first `num_hist_layers` post-layer
    states as one float32 [num_hist_layers, N, H] tensor (still on the
    graph: `_train_body` detaches it for the refresh)."""
    forward = make_forward_fn(model, cfg, compute_dtype)

    def loss_fn(batch: GraphBatch):
        if not num_hist_layers:
            outputs, outputs_var = forward(batch)
        else:
            states = []
            outputs, outputs_var = forward(batch, states=states)
        total, tasks = multihead_loss(cfg, loss_name, outputs, outputs_var,
                                      _seed_loss_batch(batch))
        if not num_hist_layers:
            return total, _task_metrics(total, tasks)
        return total, _task_metrics(total, tasks), torch.stack(
            [states[i].float() for i in range(num_hist_layers)])

    return loss_fn


class _HistBinding:
    """What a historical step reads beside the batch: the tables (bound at
    the first call; on the card a replay raises if their tensors change)
    and, for a train step, `ctl`, an int32 [2] tensor (the step before the
    update, the refresh flag) filled before each call: on the card one
    static tensor the captured graph reads, so neither the step nor the
    flag is baked into it."""

    def __init__(self):
        self.tables = None
        self.ctl: Optional[torch.Tensor] = None

    def bind(self, tables) -> None:
        if tables is None:
            raise ValueError("a historical-mode sampled step takes the "
                             "HistTables (preprocess/sampling."
                             "init_hist_tables) as its third argument")
        self.tables = tables

    def fill(self, step: int, do_refresh: bool,
             device: torch.device) -> None:
        host = torch.tensor([int(step), int(bool(do_refresh))],
                            dtype=torch.int32)
        if device.type == "cpu":
            self.ctl = host
            return
        if self.ctl is None or self.ctl.device != device:
            self.ctl = torch.zeros(2, dtype=torch.int32, device=device)
        self.ctl.copy_(host.pin_memory(), non_blocking=True)


def _hist_view(batch: GraphBatch, tables) -> GraphBatch:
    """The batch the encoder sees in historical mode: each cache-served
    slot's features from the resident table, every slot's stale states
    gathered by its global id."""
    ids = batch.node_global.long()
    x = torch.where(batch.hist_mask[:, None], tables.feat[ids], batch.x)
    return batch.replace(x=x, hist_states=tables.layers[:, ids])


def _sampled_train_body(model, cfg: ModelConfig, tx: Optimizer,
                        loss_name: str, compute_dtype,
                        hist: Optional[_HistBinding]) -> Callable:
    """body(state, batch, scalars) -> (metrics, None): one eager sampled
    step, in place; in historical mode also the staleness read, the
    update, and the refresh of the bound tables (rows of
    `batch.refresh_upto` >= t, in place, with the flag on; the dump row
    otherwise), `versions` stamped with the step after the update."""
    num_hist = max(int(cfg.num_conv_layers) - 1, 0) if hist else 0
    optimizer_step = _train_body(model, cfg, tx, make_sampled_loss_fn(
        model, cfg, loss_name, compute_dtype, num_hist))
    if hist is None:
        return optimizer_step

    def hist_body(state: TrainState, batch: GraphBatch, scalars=None):
        tables, ctl = hist.tables, hist.ctl
        ids = batch.node_global.long()
        hm = batch.hist_mask
        step_before = ctl[0]
        # what this step consumes, read before the update
        hist_n = hm.sum()
        stale = torch.where(hm, step_before - tables.versions[ids],
                            torch.zeros_like(tables.versions[ids]))
        staleness = (stale.sum().float()
                     / torch.clamp(hist_n, min=1).float())
        metrics, inter = optimizer_step(state, _hist_view(batch, tables),
                                        scalars)
        metrics["hist_staleness"] = staleness
        # times the float32 reciprocal: XLA folds JAX's division by the
        # constant slot count into that product, which rounds otherwise
        metrics["hist_frac"] = hist_n.float() * float(
            np.float32(1.0 / hm.shape[0]))
        dump = tables.feat.shape[0] - 1
        on = ctl[1] != 0
        with torch.no_grad():
            for t in range(1, tables.layers.shape[0] + 1):
                rows = torch.where(on & (batch.refresh_upto >= t), ids, dump)
                tables.layers[t - 1].index_put_((rows,), inter[t - 1])
            rows = torch.where(on & (batch.refresh_upto >= 1), ids, dump)
            tables.versions.index_put_(
                (rows,), (step_before + 1).to(torch.int32).expand(
                    rows.shape[0]))
        return metrics, None

    hist_body.loss_fn = optimizer_step.loss_fn
    return hist_body


class SampledTrainStep:
    """The sampled train step: `step(state, batch)` in exact mode,
    `step(state, batch, tables, do_refresh)` -> (state, tables, metrics)
    in historical mode (the tables updated in place; `do_refresh` a host
    bool, on the card copied into the static flag the graph reads, so
    alternating it never recaptures). One CUDA graph for the
    run on the card, the eager step on the CPU; `eager(...)` runs the
    eager step on any device."""

    def __init__(self, model, cfg: ModelConfig, tx: Optimizer,
                 loss_name: str, compute_dtype, hist: bool):
        self.hist = _HistBinding() if hist else None
        self.steps = GraphedSteps(
            model, _sampled_train_body(model, cfg, tx, loss_name,
                                       compute_dtype, self.hist), tx,
            mode="train",
            extra_state=(lambda: self.hist.tables) if hist else None)

    def _prepare(self, state, batch, tables, do_refresh):
        if self.hist is None:
            if tables is not None:
                raise ValueError("an exact-mode sampled step (staleness_k "
                                 "0) takes no historical tables")
            return
        self.hist.bind(tables)
        self.hist.fill(state.step, do_refresh, batch.x.device)

    def _out(self, state, tables, metrics):
        return (state, metrics) if self.hist is None else (state, tables,
                                                           metrics)

    def __call__(self, state: TrainState, batch: GraphBatch, tables=None,
                 do_refresh=False):
        self._prepare(state, batch, tables, do_refresh)
        stacked, per_step, _ = self.steps(state, [batch])
        metrics = (per_step[0] if per_step is not None
                   else {k: v[0] for k, v in stacked.items()})
        return self._out(state, tables, metrics)

    def eager(self, state: TrainState, batch: GraphBatch, tables=None,
              do_refresh=False):
        self._prepare(state, batch, tables, do_refresh)
        _, per_step, _ = self.steps.eager(state, [batch])
        return self._out(state, tables, per_step[0])


def make_sampled_train_step(model, cfg: ModelConfig, tx: Optimizer, *,
                            loss_name: str = "ce", staleness_k: int = 0,
                            compute_dtype=None) -> SampledTrainStep:
    """The train step of fixed-shape sampled batches
    (preprocess/sampling.py): every batch has the same shapes, so on the
    card it is one CUDA graph for the run. `staleness_k` > 0 is the
    historical mode (`SampledTrainStep`); the refresh cadence is the
    caller's `step % K == 0`, so K never enters the step. Historical mode
    refuses stacks whose encoder cannot apply the cache
    (`models.base.check_hist_encode`)."""
    hist = int(staleness_k) > 0
    if hist:
        check_hist_encode(model)
    return SampledTrainStep(model, cfg, tx, loss_name, compute_dtype, hist)


def _sampled_eval_body(model, cfg: ModelConfig, loss_name: str,
                       compute_dtype, hist: Optional[_HistBinding]
                       ) -> Callable:
    """body(state, batch, scalars) -> (metrics, outputs) in eval mode: the
    seed-masked loss, and for a classification node head (y_node wider
    than one column) `correct` / `count`, the top-1 hits and the seeds
    counted; in historical mode on the stale view of the bound tables."""
    forward = make_forward_fn(model, cfg, compute_dtype)

    def body(state: TrainState, batch: GraphBatch, scalars=None):
        model.eval()
        if hist is not None:
            batch = _hist_view(batch, hist.tables)
        with torch.no_grad():
            outputs, outputs_var = forward(batch)
            total, tasks = multihead_loss(cfg, loss_name, outputs,
                                          outputs_var,
                                          _seed_loss_batch(batch))
            metrics = _task_metrics(total, tasks)
            if batch.y_node is not None and batch.y_node.shape[-1] > 1:
                nclass = batch.y_node.shape[-1]
                pred = torch.argmax(outputs[0][..., :nclass], dim=-1)
                label = torch.argmax(batch.y_node, dim=-1)
                sm = (batch.seed_mask if batch.seed_mask is not None
                      else batch.node_mask)
                metrics["correct"] = (sm & (pred == label)).sum().float()
                metrics["count"] = sm.sum().float()
        return metrics, outputs

    return body


class SampledEvalStep:
    """eval(state, batch) -> (metrics, outputs) in exact mode,
    eval(state, batch, tables) in historical mode (the tables read only):
    a captured graph on the card, the eager step on the CPU."""

    def __init__(self, model, cfg: ModelConfig, loss_name: str,
                 compute_dtype, hist: bool):
        self.hist = _HistBinding() if hist else None
        self.steps = GraphedSteps(
            model, _sampled_eval_body(model, cfg, loss_name, compute_dtype,
                                      self.hist),
            mode="eval", keep_outputs=True,
            extra_state=(lambda: self.hist.tables) if hist else None)

    def __call__(self, state: TrainState, batch: GraphBatch, tables=None):
        if self.hist is not None:
            self.hist.bind(tables)
        stacked, per_step, outputs = self.steps(state, [batch])
        return (per_step[0] if per_step is not None
                else {k: v[0] for k, v in stacked.items()}), outputs

    def eager(self, state: TrainState, batch: GraphBatch, tables=None):
        if self.hist is not None:
            self.hist.bind(tables)
        _, per_step, outputs = self.steps.eager(state, [batch])
        return per_step[0], outputs


def make_sampled_eval_step(model, cfg: ModelConfig, loss_name: str = "ce",
                           staleness_k: int = 0,
                           compute_dtype=None) -> SampledEvalStep:
    """The eval step of sampled batches (`SampledEvalStep`); historical
    mode applies the same stale view as training."""
    hist = int(staleness_k) > 0
    if hist:
        check_hist_encode(model)
    return SampledEvalStep(model, cfg, loss_name, compute_dtype, hist)
