"""Train and eval steps (counterpart: hydragnn_tpu/train/train_step.py).

A step is one eager forward, `torch.autograd.grad` of the loss with
respect to the model's parameters, the optimizer's update and its
addition to the parameters — what the JAX package jits into one program.
The model holds its parameters and buffers; a `TrainState` names them
(the same tensors) beside the optimizer state and the step count, so a
state can be snapshot (`copy`) and put back (`restore`).

`make_train_step` puts the model in training mode (BatchNorm on batch
statistics, running statistics updated once per step); `make_eval_step`
in eval mode. The energy-force path (`compute_grad_energy`) takes the
forces with `create_graph=True` in training and without it in
evaluation, which still needs gradients to the positions and so runs
under `torch.enable_grad()`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..config.config import ModelConfig
from ..graphs.batch import GraphBatch
from .loss import energy_force_loss, multihead_loss
from .optimizer import Optimizer, OptState


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
    def create(cls, model: torch.nn.Module, tx: Optimizer) -> "TrainState":
        params = dict(model.named_parameters())
        return cls(params=params, batch_stats=dict(model.named_buffers()),
                   opt_state=tx.init(list(params.values())), step=0)

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
        model's), in place; returns self."""
        with torch.no_grad():
            for live, snap in ((self.params, snapshot.params),
                               (self.batch_stats, snapshot.batch_stats)):
                for k, v in live.items():
                    v.copy_(snap[k])
        self.opt_state = _clone_opt_state(snapshot.opt_state)
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


def make_loss_fn(model, cfg: ModelConfig, loss_name: str = "mse",
                 compute_grad_energy: bool = False,
                 energy_weight: float = 1.0, force_weight=1.0):
    """loss_fn(batch) -> (total, metrics) of the model as it stands (its
    mode decides the BatchNorm statistics): the multihead loss, or on the
    energy-force path the energy + force loss with the forces' graph kept
    for a gradient with respect to the weights."""

    def loss_fn(batch: GraphBatch):
        if compute_grad_energy:
            total, aux = energy_force_loss(model, cfg, batch, loss_name,
                                           energy_weight, force_weight,
                                           create_graph=True)
            return total, {"loss": total, "energy_loss": aux["energy_loss"],
                           "force_loss": aux["force_loss"]}
        outputs, outputs_var = model(batch)
        total, tasks = multihead_loss(cfg, loss_name, outputs, outputs_var,
                                      batch)
        metrics = {"loss": total}
        for i, t in enumerate(tasks):
            metrics[f"task_{i}"] = t
        return total, metrics

    return loss_fn


def make_train_step(model, cfg: ModelConfig, tx: Optimizer,
                    loss_name: str = "mse", compute_grad_energy: bool = False,
                    energy_weight: float = 1.0,
                    force_weight=1.0) -> Callable:
    """step(state, batch) -> (state, metrics): one optimizer step on the
    state's parameters (the model's), in place. metrics are detached
    0-dim tensors: loss, task_i or energy_loss/force_loss, and
    nonfinite_steps (computed before the conv freeze)."""
    loss_fn = make_loss_fn(model, cfg, loss_name, compute_grad_energy,
                           energy_weight, force_weight)

    def step(state: TrainState, batch: GraphBatch):
        model.train()
        names = list(state.params)
        params = list(state.params.values())
        total, metrics = loss_fn(batch)
        # a parameter off the loss's graph (SchNet's coordinate MLP, whose
        # positions the heads never read) gets a zero gradient, as in JAX
        grads = torch.autograd.grad(total, params, allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["nonfinite_steps"] = _nonfinite_watchdog(total, grads)
        grads = freeze_conv_grads(names, list(grads), cfg)
        updates, state.opt_state = tx.update(grads, state.opt_state, params)
        updates = freeze_conv_grads(names, updates, cfg)
        if updates is not None:
            with torch.no_grad():
                torch._foreach_add_(params, updates)
        state.step += 1
        return state, metrics

    return step


def eval_metrics_and_outputs(model, cfg: ModelConfig, loss_name: str,
                             batch: GraphBatch,
                             compute_grad_energy: bool = False,
                             energy_weight: float = 1.0, force_weight=1.0):
    """(metrics, outputs) of the model in eval mode on one batch; on the
    energy-force path outputs are [energies, forces]."""
    model.eval()
    if compute_grad_energy:
        total, aux = energy_force_loss(model, cfg, batch, loss_name,
                                       energy_weight, force_weight,
                                       create_graph=False)
        metrics = {"loss": total.detach(),
                   "energy_loss": aux["energy_loss"].detach(),
                   "force_loss": aux["force_loss"].detach()}
        return metrics, [aux["energy_pred"], aux["forces_pred"]]
    with torch.no_grad():
        outputs, outputs_var = model(batch)
        total, tasks = multihead_loss(cfg, loss_name, outputs, outputs_var,
                                      batch)
    metrics = {"loss": total}
    for i, t in enumerate(tasks):
        metrics[f"task_{i}"] = t
    return metrics, outputs


def make_eval_step(model, cfg: ModelConfig, loss_name: str = "mse",
                   compute_grad_energy: bool = False,
                   energy_weight: float = 1.0,
                   force_weight=1.0) -> Callable:
    """eval_step(state, batch) -> (metrics, outputs) with the state's
    parameters (the model's) in eval mode."""

    def eval_step(state: TrainState, batch: GraphBatch):
        return eval_metrics_and_outputs(model, cfg, loss_name, batch,
                                        compute_grad_energy, energy_weight,
                                        force_weight)

    return eval_step
